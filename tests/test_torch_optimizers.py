"""PyTorch port: the 14 optimizers against the JAX package's.

The same parameters and the same gradients (those of sum(p * G) for a
seeded G each step, so both sides hold exactly G) go to both packages;
after every step the parameters, float32 masters and slots must agree at
atol 1e-6 (float32 updates of the same formulas; the JAX package fuses
its step into one XLA program, which may round an intermediate
differently). A bf16 parameter is its master rounded to bf16 on both
sides: within one bf16 ulp (rtol 2^-7). Eight steps: RAdam takes its
rectified branch from step 7 (rho_t > 5). Cases cover parameter groups
(their own rate multiplier and weight decay), a per-parameter multiplier
(``optimize_attr``), L1 decay, ``amsgrad``, ``apply_decay_param_fun``,
``lr_ratio``, a scheduler as the rate, and bf16 masters.

ASGD's ``avg`` slot is held to the mean of the port's own iterates: the
JAX package's fused eager step traces ``float(self._global_step)`` once,
so its ``avg`` stays equal to the newest iterate (n = 1 at every step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg

ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
STEPS = 8
SHAPES = {"w1": (4, 3), "b1": (3,), "w2": (5,)}


def _sched(m):
    return m.lr.LinearWarmup(m.lr.CosineAnnealingDecay(0.02, T_max=6),
                             warmup_steps=3, start_lr=0.002, end_lr=0.02)


def _items(ps):
    """The JAX package's parameters carry their names; the port's come as
    (name, param) pairs."""
    return [(n, p) if torch.is_tensor(p) else p for n, p in ps.items()]


def _groups(ps, wd=0.02):
    items = _items(ps)
    return [{"params": items[:2], "learning_rate": 0.5, "weight_decay": wd},
            {"params": items[2:]}]


# name -> (factory(optimizer module, regularizer module, params), groups?)
CASES = {
    "sgd_l1": lambda m, r, ps: m.SGD(0.1, parameters=_items(ps),
                                     weight_decay=r.L1Decay(0.01)),
    "momentum": lambda m, r, ps: m.Momentum(0.05, momentum=0.9,
                                            parameters=_groups(ps)),
    "momentum_nesterov": lambda m, r, ps: m.Momentum(
        0.05, parameters=_items(ps), use_nesterov=True,
        weight_decay=r.L2Decay(0.01)),
    "adagrad": lambda m, r, ps: m.Adagrad(0.1, parameters=_groups(ps),
                                          initial_accumulator_value=0.1),
    "adadelta": lambda m, r, ps: m.Adadelta(1.0, rho=0.9,
                                            parameters=_items(ps)),
    "rmsprop": lambda m, r, ps: m.RMSProp(0.01, parameters=_groups(ps)),
    "rmsprop_centered": lambda m, r, ps: m.RMSProp(
        0.01, centered=True, momentum=0.5, parameters=_items(ps)),
    "rprop": lambda m, r, ps: m.Rprop(0.01, parameters=_items(ps)),
    "asgd": lambda m, r, ps: m.ASGD(0.1, parameters=_groups(ps)),
    "adam_sched": lambda m, r, ps: m.Adam(_sched(m),
                                          parameters=_items(ps)),
    "adam_amsgrad": lambda m, r, ps: m.Adam(0.01, parameters=_groups(ps),
                                            amsgrad=True),
    "adamw_decay_fun": lambda m, r, ps: m.AdamW(
        0.01, parameters=_groups(ps, wd=None), weight_decay=0.1,
        apply_decay_param_fun=lambda n: not n.startswith("b")),
    "adamw_sched_amsgrad": lambda m, r, ps: m.AdamW(
        _sched(m), parameters=_items(ps), amsgrad=True),
    "adamax": lambda m, r, ps: m.Adamax(0.01, parameters=_groups(ps)),
    "nadam": lambda m, r, ps: m.NAdam(0.01, parameters=_items(ps)),
    "radam": lambda m, r, ps: m.RAdam(0.01, parameters=_groups(ps)),
    "lamb": lambda m, r, ps: m.Lamb(
        0.01, lamb_weight_decay=0.05, parameters=_items(ps),
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _params(arrays, dtype):
    """The JAX package's parameters and the port's, named and with w2's
    rate doubled through ``optimize_attr``."""
    jps, tps = {}, {}
    for n, a in arrays.items():
        jps[n] = JParameter(jnp.asarray(a, dtype), name=n)
        tps[n] = torch.nn.Parameter(torch.from_numpy(a).to(
            getattr(torch, dtype)))
    jps["w2"].optimize_attr["learning_rate"] = 2.0
    tps["w2"].optimize_attr = {"learning_rate": 2.0}
    return jps, tps


def _backward(jps, tps, grads, dtype):
    """Leave exactly G in every .grad: the gradient of sum(p * G)."""
    jl = sum((p * JParameter(jnp.asarray(grads[n], dtype))).sum()
             for n, p in jps.items())
    jl.backward()
    tl = sum((p * torch.from_numpy(grads[n]).to(p.dtype)).sum()
             for n, p in tps.items())
    tl.backward()


def _check(jo, to, jps, tps, dtype, what):
    for n in SHAPES:
        jp, tp = jps[n], tps[n]
        a = tp.detach().float().numpy()
        ref = np.asarray(jp._data.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, ref, atol=ATOL,
                                       err_msg=f"{what} {n}")
        else:
            np.testing.assert_allclose(a, ref, rtol=BF16_RTOL, atol=ATOL,
                                       err_msg=f"{what} {n}")
        jst, tst = jo._state[id(jp)], to._state[id(tp)]
        assert (tst["master"] is None) == (jst["master"] is None)
        for slot, t in tst.items():
            if t is None or slot == "avg":
                continue
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jst[slot]), atol=ATOL,
                err_msg=f"{what} {n}.{slot}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_steps_match_jax(name, dtype):
    jps, tps = _params(_arrays(), dtype)
    jo = CASES[name](jopt, jreg, jps)
    to = CASES[name](topt, treg, tps)
    iterates = []
    for step in range(STEPS):
        assert to.get_lr() == jo.get_lr()
        _backward(jps, tps, _grads(step), dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in tps.values())
        _check(jo, to, jps, tps, dtype, f"{name} step {step + 1}")
        iterates.append((to._slots_for(tps["w1"])["master"]
                         if dtype == "bfloat16" else tps["w1"]).detach()
                        .clone())
        if to._lr_scheduler is not None:
            jo._lr_scheduler.step()
            to._lr_scheduler.step()
    assert to._global_step == STEPS
    if name == "asgd":
        torch.testing.assert_close(to._state[id(tps["w1"])]["avg"],
                                   torch.stack(iterates).mean(0))


def test_lr_ratio_scales_a_parameters_rate():
    """``lr_ratio(param)`` multiplies the rate of the Adam step and of the
    decay, as a per-parameter multiplier does (the JAX package ignores
    ``lr_ratio``; it is held against ``optimize_attr`` there)."""
    ratio = {"w1": 0.5, "b1": 1.0, "w2": 2.0}
    jps, tps = _params(_arrays(1), "float32")
    for n, p in jps.items():
        p.optimize_attr["learning_rate"] = ratio[n]
    tps["w2"].optimize_attr = {"learning_rate": 1.0}
    jo = jopt.AdamW(0.01, parameters=list(jps.values()), weight_decay=0.1)
    names = {id(p): n for n, p in tps.items()}
    to = topt.AdamW(0.01, parameters=list(tps.values()), weight_decay=0.1,
                    lr_ratio=lambda p: ratio[names[id(p)]])
    for step in range(3):
        _backward(jps, tps, _grads(step), "float32")
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        _check(jo, to, jps, tps, "float32", f"lr_ratio step {step + 1}")


def test_scheduler_rate_and_state_dict_round_trip():
    """``get_lr`` follows the scheduler; ``set_lr`` is refused then;
    ``state_dict`` carries the slots, the step and ``LR_Scheduler`` (the
    JAX package's keys) and restores them into a fresh optimizer."""
    jps, tps = _params(_arrays(2), "float32")
    jo = jopt.Adam(_sched(jopt), parameters=list(jps.values()))
    to = topt.Adam(_sched(topt), parameters=_items(tps))
    for step in range(4):
        _backward(jps, tps, _grads(step), "float32")
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        jo._lr_scheduler.step()
        to._lr_scheduler.step()
    with pytest.raises(RuntimeError):
        to.set_lr(0.1)
    sd, jsd = to.state_dict(), jo.state_dict()
    assert set(sd) == set(jsd)
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]
    assert sd["global_step"] == jsd["global_step"] == 4
    fresh = {n: torch.nn.Parameter(p.detach().clone())
             for n, p in tps.items()}
    to2 = topt.Adam(_sched(topt), parameters=_items(fresh))
    to2.set_state_dict(sd)
    assert to2.get_lr() == to.get_lr()
    for n in SHAPES:
        for slot in ("moment1", "moment2"):
            assert torch.equal(to2._state[id(fresh[n])][slot],
                               to._state[id(tps[n])][slot])
    plain = topt.SGD(0.1, parameters=[fresh["w1"]])
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25
    plain.set_lr_scheduler(_sched(topt))
    assert plain.get_lr() == _sched(topt).last_lr


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    """L-BFGS on a least-squares problem, two steps of a closure: the
    parameters after each step and the losses it returns (float32 dot
    products in a different order: atol 1e-5)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((12, 6)).astype(np.float32)
    y = rng.standard_normal((12,)).astype(np.float32)
    x0 = np.zeros(6, np.float32)
    jx = JParameter(jnp.asarray(x0))
    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    ja, jy_ = JParameter(jnp.asarray(a)), JParameter(jnp.asarray(y))
    ja.stop_gradient = jy_.stop_gradient = True
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)

    def jclosure():
        r = (ja * jx).sum(axis=1) - jy_
        loss = (r * r).sum()
        loss.backward()
        return loss

    def tclosure():
        loss = ((ta @ tx - ty) ** 2).sum()
        loss.backward()
        return loss

    jo = jopt.LBFGS(learning_rate=0.05, max_iter=5, history_size=4,
                    line_search_fn=line_search, parameters=[jx])
    to = topt.LBFGS(learning_rate=0.05, max_iter=5, history_size=4,
                    line_search_fn=line_search, parameters=[tx])
    first = None
    for _ in range(2):
        jl = float(np.asarray(jo.step(jclosure).numpy()))
        tl = float(to.step(tclosure))
        first = first or tl
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx.detach().numpy(),
                                   np.asarray(jx._data), atol=1e-5)
    assert to._n_evals == jo._n_evals
    assert float(tclosure().detach()) < first


def test_train_step_follows_a_scheduler(monkeypatch):
    """``TrainStep`` reads the optimizer's rate at each call: the tiny GPT
    trained three steps by both packages' ``TrainStep`` under the same
    warm-up schedule (stepped between calls) gives the same losses
    (float32, rtol 1e-4 as in tests/test_torch_train_step.py), and the
    rates its updates used are the schedule's."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch import GPT, GPTConfig, TrainStep
    from paddle_tpu_torch.convert import gpt_params_from_numpy
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    cfg = jgpt.GPTConfig.tiny()
    paddle.seed(0)
    jm = jgpt.GPT(cfg)
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = GPT(GPTConfig.tiny(), device="cpu")
    tm.load_state_dict(gpt_params_from_numpy(named, cfg))
    ids = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(
        np.int64)
    js, ts = _sched(jopt), _sched(topt)
    jo = jopt.AdamW(js, parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    to = topt.AdamW(ts, parameters=tm.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
    rates = []
    apply = to._apply_param
    first = to._parameter_list[0]

    def spy(p32, g32, state, lr, group, t, param=None):
        if param is first:
            rates.append(lr)
        return apply(p32, g32, state, lr, group, t, param)

    to._apply_param = spy
    jstep = paddle.jit.TrainStep(jm, jo, lambda m, x: m.loss(x, x))
    tstep = TrainStep(tm, to, lambda m, x: m.loss(x, x))
    jl, tl, want = [], [], []
    for _ in range(3):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(ids)).numpy())))
        want.append(ts.last_lr)
        tl.append(tstep(torch.from_numpy(ids)).item())
        js.step()
        ts.step()
    assert rates == want and len(set(want)) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
