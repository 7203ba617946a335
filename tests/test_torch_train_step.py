"""PyTorch port: global-norm clip, AdamW and ``TrainStep`` against the JAX
package on the CPU.

The clip and the update are fed the same parameters, gradients and state
on both sides (the JAX side through the pure forms its compiled train step
runs: ``ClipGradByGlobalNorm._clip_arrays`` and ``Optimizer._apply_param``)
and compared at atol 1e-6. The tiny GPT is then trained three steps by
both ``TrainStep``s from the same parameters and batch (the JAX side's
attention through the Pallas kernels in interpret mode); the losses must
agree at rtol 1e-4 at each step. Parameters are not compared after several
Adam steps: a gradient near epsilon can flip a step of size lr.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import AdamW, GPT, GPTConfig, TrainStep
from paddle_tpu_torch.convert import gpt_params_from_numpy
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam

ATOL = 1e-6


def _state(rng, shape):
    return {"m": rng.standard_normal(shape).astype(np.float32) * 0.01,
            "v": np.abs(rng.standard_normal(shape)).astype(np.float32)
            * 1e-4}


def _jax_update(opt, p32, g32, st, lr, t):
    opt._t = t
    new, nst = opt._apply_param(
        jnp.asarray(p32), jnp.asarray(g32),
        {"master": None, "moment1": jnp.asarray(st["m"]),
         "moment2": jnp.asarray(st["v"])}, lr, opt._groups[0])
    return (np.asarray(new), np.asarray(nst["moment1"]),
            np.asarray(nst["moment2"]))


@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_clip_then_adamw_on_identical_inputs(wd):
    """A float32 parameter (its own float32 copy) and a bf16 parameter with
    a float32 master, at step t = 3. Parity trap 1: the clip casts each
    grad back to its own dtype, so the bf16 grad is rounded before the f32
    update; trap 2: AdamW decays every parameter with the old p32, after
    the Adam step."""
    rng = np.random.default_rng(0)
    p_f = rng.standard_normal((6, 5)).astype(np.float32)
    master = rng.standard_normal((7,)).astype(np.float32)
    p_b = torch.from_numpy(master).bfloat16()
    g_f = rng.standard_normal((6, 5)).astype(np.float32) * 3.0
    g_b = torch.from_numpy(rng.standard_normal((7,)).astype(np.float32)
                           * 3.0).bfloat16()
    st_f, st_b = _state(rng, (6, 5)), _state(rng, (7,))

    # the port
    tp_f = torch.nn.Parameter(torch.from_numpy(p_f.copy()))
    tp_b = torch.nn.Parameter(p_b.clone())
    tp_f.grad, tp_b.grad = torch.from_numpy(g_f.copy()), g_b.clone()
    opt = AdamW(1e-2, parameters=[tp_f, tp_b], weight_decay=wd,
                grad_clip=ClipGradByGlobalNorm(1.0))
    for p, st, m in ((tp_f, st_f, None), (tp_b, st_b, master)):
        opt._state[id(p)] = {
            "master": None if m is None else torch.from_numpy(m.copy()),
            "moment1": torch.from_numpy(st["m"].copy()),
            "moment2": torch.from_numpy(st["v"].copy())}
    opt._global_step = 2
    opt.step()
    assert opt._global_step == 3

    # the JAX package, same inputs
    jclip = jnn.ClipGradByGlobalNorm(1.0)
    cg_f, cg_b = jclip._clip_arrays(
        [jnp.asarray(g_f), jnp.asarray(g_b.float().numpy()).astype(
            jnp.bfloat16)])
    assert cg_b.dtype == jnp.bfloat16
    jo = jopt.AdamW(1e-2, parameters=[paddle.to_tensor(p_f)],
                    weight_decay=wd)
    new_f, m_f, v_f = _jax_update(jo, p_f, np.asarray(cg_f), st_f, 1e-2, 3)
    new_b, m_b, v_b = _jax_update(
        jo, master, np.asarray(cg_b.astype(jnp.float32)), st_b, 1e-2, 3)

    np.testing.assert_allclose(tp_f.detach().numpy(), new_f, atol=ATOL)
    st = opt._state[id(tp_f)]
    assert st["master"] is None  # f32: the parameter is the f32 copy
    np.testing.assert_allclose(st["moment1"].numpy(), m_f, atol=ATOL)
    np.testing.assert_allclose(st["moment2"].numpy(), v_f, atol=ATOL)
    st = opt._state[id(tp_b)]
    np.testing.assert_allclose(st["master"].numpy(), new_b, atol=ATOL)
    np.testing.assert_allclose(st["moment1"].numpy(), m_b, atol=ATOL)
    np.testing.assert_allclose(st["moment2"].numpy(), v_b, atol=ATOL)
    assert tp_b.dtype == torch.bfloat16
    assert torch.equal(tp_b.detach(), st["master"].bfloat16())
    # the bf16 grad left the clip rounded to bf16
    assert tp_b.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp_b.grad.float().numpy(),
                                  np.asarray(cg_b.astype(jnp.float32)))


def test_masters_only_for_low_precision_and_first_step_is_t1():
    """Parity trap 3: masters exist only for bf16/fp16 parameters; trap 4:
    t = 1 on the first step."""
    p32 = torch.nn.Parameter(torch.ones(3))
    p16 = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    for p in (p32, p16):
        p.grad = torch.full_like(p, 0.5)
    opt = Adam(0.1, parameters=[p32, p16])
    opt.step()
    assert opt._state[id(p32)]["master"] is None
    assert opt._state[id(p16)]["master"].dtype == torch.float32
    # t = 1: m_hat = g, v_hat = g^2, so the step is lr * g / (|g| + eps)
    torch.testing.assert_close(p32.detach(), torch.full((3,), 0.9))
    off = Adam(0.1, parameters=[p16], multi_precision=False)
    p16.grad = torch.full_like(p16, 0.5)
    off.step()
    assert off._state[id(p16)]["master"] is None


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", 1e-3)])
def test_gpt_trained_three_steps_matches_jax_train_step(monkeypatch, dtype,
                                                        rtol):
    """float32, and bf16 parameters with float32 masters on both sides
    (their bf16 rounding differs by an ulp here and there: rtol 1e-3)."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    cfg = jgpt.GPTConfig.tiny()
    paddle.seed(0)
    jm = jgpt.GPT(cfg)
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
    named = {n: np.asarray(p._data.astype(jnp.float32))
             for n, p in jm.named_parameters()}
    ids = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(
        np.int64)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    jstep = paddle.jit.TrainStep(jm, jo, lambda m, x: m.loss(x, x))
    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(3)]

    tdtype = getattr(torch, dtype)
    tm = GPT(GPTConfig.tiny(), device="cpu", dtype=tdtype)
    tm.load_state_dict(gpt_params_from_numpy(named, cfg, dtype=tdtype))
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, to, lambda m, x: m.loss(x, x))
    tl = []
    for _ in range(3):
        loss = tstep(torch.from_numpy(ids))
        assert loss.grad_fn is None and not loss.requires_grad
        assert all(p.grad is None for p in tm.parameters())
        tl.append(loss.item())
    assert to._global_step == 3
    masters = [st["master"] for st in to._state.values()]
    assert all((m is None) == (dtype == "float32") for m in masters)
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[2] < tl[0]
