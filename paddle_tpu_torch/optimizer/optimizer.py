"""Optimizer base and the classic optimizers (mirrors
``paddle_tpu/optimizer/optimizer.py``).

``parameters`` is a list of parameters or of groups (dicts with ``params``
and optional ``learning_rate`` (a multiplier) and ``weight_decay``); a
parameter may come as a ``(name, param)`` pair, as ``named_parameters()``
yields them. The name stands in for the JAX package's ``param.name``
(torch tensors have no writable one): AdamW's ``apply_decay_param_fun``
reads it, and ``state_dict`` keys by it (``param_{i}`` when unnamed).
``learning_rate`` is a float or an ``lr.LRScheduler``; ``get_lr()`` reads
the scheduler's ``last_lr`` (the value the JAX package's ``TrainStep``
passes in). Each parameter's rate is ``get_lr() * (group multiplier *
param.optimize_attr["learning_rate"])``; a parameter without an
``optimize_attr`` attribute has multiplier 1. ``weight_decay`` is a float
(L2), ``regularizer.L2Decay`` or ``L1Decay``; coupled decay folds into the
gradient before the update, decoupled decay (AdamW) subtracts
``lr * wd * p32`` (the old float32 parameter) after it.

With ``multi_precision`` (the default) a bf16/fp16 parameter gets a
float32 master copy; the update runs on the master and the parameter
receives ``master.to(param dtype)``. A float32 parameter is itself the
float32 copy and has no master. Slots are float32. Each rule is
``_update(p32, g32, state, lr, t) -> new p32`` on float32 tensors, the
slot dict updated in place, ``t`` the step (1 on the first).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _decay_mode(wd):
    """weight_decay (float | L1Decay | L2Decay | None) -> (mode, coeff)."""
    if wd is None:
        return None, None
    from ..regularizer import L1Decay, L2Decay
    if isinstance(wd, L1Decay):
        return "l1", float(wd.coeff)
    if isinstance(wd, L2Decay):
        return "l2", float(wd.coeff)
    return "l2", float(wd)


def _lr_mult(p):
    """A parameter's own rate multiplier (``optimize_attr``), 1 if none."""
    return getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)


class Optimizer:
    # names of per-parameter float32 slots, e.g. ("moment1", "moment2")
    _slot_names: tuple = ()
    # decoupled (AdamW-style) decay instead of decay folded into g
    _decoupled = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True):
        if parameters is None:
            raise ValueError("parameters is required")
        self._lr = learning_rate
        self._lr_scheduler = learning_rate \
            if isinstance(learning_rate, LRScheduler) else None
        self._names: dict[int, str] = {}  # id(param) -> its name
        self._groups = self._build_groups(parameters, weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # id(param) -> {"master": tensor or None, slot name: tensor}
        self._state: dict[int, dict] = {}
        self._global_step = 0

    def _unname(self, params):
        out = []
        for p in params:
            if isinstance(p, tuple):
                name, p = p
                self._names[id(p)] = name
            out.append(p)
        return out

    def _build_groups(self, parameters, weight_decay):
        mode, wd = _decay_mode(weight_decay)
        params = list(parameters)
        if not (params and isinstance(params[0], dict)):
            params = [{"params": params}]
        groups = []
        for g in params:
            own = g.get("weight_decay")
            gm, gw = _decay_mode(own) if own is not None else (mode, wd)
            groups.append({"params": self._unname(g["params"]),
                           "lr_mult": float(g.get("learning_rate", 1.0)),
                           "wd_mode": gm, "weight_decay": gw})
        return groups

    # -- lr ------------------------------------------------------------
    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler.last_lr)
        return float(self._lr)

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError(
                "cannot set_lr when the learning rate is an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler

    # -- state ---------------------------------------------------------
    @property
    def _parameter_list(self):
        return [p for g in self._groups for p in g["params"]]

    def _slots_for(self, p):
        st = self._state.get(id(p))
        if st is None:
            needs_master = self._multi_precision and \
                p.dtype in _LOW_PRECISION
            st = {"master": p.detach().float() if needs_master else None}
            for name in self._slot_names:
                st[name] = self._init_slot(name, p)
            self._state[id(p)] = st
        return st

    def _init_slot(self, name, p):
        return torch.zeros(p.shape, device=p.device, dtype=torch.float32)

    # -- the update rule -----------------------------------------------
    def _update(self, p32, g32, state, lr, t):
        """The update rule: float32 param and grad, the slot dict (updated
        in place), lr and step t -> the new float32 param."""
        raise NotImplementedError

    def _decay_grad(self, p32, g32, group):
        if group["wd_mode"] == "l1":
            return g32 + group["weight_decay"] * torch.sign(p32)
        return g32 + group["weight_decay"] * p32

    def _wants_decay(self, param):
        return True

    def _apply_param(self, p32, g32, state, lr, group, t, param=None):
        wd = group["weight_decay"]
        if wd and not self._decoupled:
            g32 = self._decay_grad(p32, g32, group)
        new = self._update(p32, g32, state, lr, t)
        if wd and self._decoupled and self._wants_decay(param):
            new = new - lr * wd * p32
        return new

    @torch.no_grad()
    def _update_all(self):
        """Clip the grads (each in its own dtype), then update every
        parameter that has a grad at step ``self._global_step``, at
        ``get_lr()`` times its multipliers."""
        t = self._global_step
        lr = self.get_lr()
        if self._grad_clip is not None:
            self._grad_clip.clip_(self._parameter_list)
        for group in self._groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._slots_for(p)
                master = st["master"]
                p32 = master if master is not None else p.float()
                new = self._apply_param(
                    p32, p.grad.float(), st,
                    lr * (group["lr_mult"] * _lr_mult(p)), group, t,
                    param=p)
                if master is not None:
                    st["master"] = new
                p.copy_(new)  # casts to the parameter's dtype

    def step(self):
        self._global_step += 1
        self._update_all()

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -- serialization -------------------------------------------------
    def _name(self, p):
        return self._names.get(id(p), "")

    def _key(self, i, p):
        return self._name(p) or f"param_{i}"

    def state_dict(self):
        """``{param key}.{slot}`` tensors (the key is the parameter's
        name or ``param_{i}``), ``global_step`` and, with a scheduler,
        ``LR_Scheduler``. The tensors are the state itself, not copies:
        an update replaces a slot and never writes into it."""
        sd = OrderedDict()
        for i, p in enumerate(self._parameter_list):
            st = self._state.get(id(p))
            if st is None:
                continue
            for name, t in st.items():
                if t is not None:
                    sd[f"{self._key(i, p)}.{name}"] = t
        sd["global_step"] = self._global_step
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if self._lr_scheduler is not None and "LR_Scheduler" in state_dict:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            st = self._slots_for(p)
            for name in list(st):
                k = f"{self._key(i, p)}.{name}"
                if k in state_dict:
                    st[name] = torch.as_tensor(state_dict[k]).to(
                        device=p.device, dtype=torch.float32).clone()


class SGD(Optimizer):
    def _update(self, p, g, state, lr, t):
        return p - lr * g


class Momentum(Optimizer):
    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, g, state, lr, t):
        v = self._momentum * state["velocity"] + g
        state["velocity"] = v
        if self._nesterov:
            return p - lr * (g + self._momentum * v)
        return p - lr * v


class Adagrad(Optimizer):
    _slot_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_slot(self, name, p):
        return torch.full(p.shape, self._init_val, device=p.device,
                          dtype=torch.float32)

    def _update(self, p, g, state, lr, t):
        m = state["moment"] + g * g
        state["moment"] = m
        return p - lr * g / (torch.sqrt(m) + self._epsilon)


class Adadelta(Optimizer):
    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._epsilon = epsilon
        self._rho = rho

    def _update(self, p, g, state, lr, t):
        rho, eps = self._rho, self._epsilon
        sg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = g * torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(sg + eps)
        su = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        state["avg_squared_grad"] = sg
        state["avg_squared_update"] = su
        return p - lr * upd


class RMSProp(Optimizer):
    _slot_names = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update(self, p, g, state, lr, t):
        rho, eps = self._rho, self._epsilon
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        state["mean_square"] = ms
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            state["mean_grad"] = mg
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        step = lr * g / denom
        if self._momentum > 0:
            step = self._momentum * state["momentum_acc"] + step
            state["momentum_acc"] = step
        return p - step


class Rprop(Optimizer):
    """Per-element step sizes, starting at the rate when the parameter's
    slots are made, grown by ``etas[1]`` while the gradient keeps its
    sign and shrunk by ``etas[0]`` when it flips (that step is skipped)."""

    _slot_names = ("prev_grad", "lr_per_elem")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _init_slot(self, name, p):
        fill = self.get_lr() if name == "lr_per_elem" else 0.0
        return torch.full(p.shape, fill, device=p.device,
                          dtype=torch.float32)

    def _update(self, p, g, state, lr, t):
        eta_minus, eta_plus = self._etas
        lo, hi = self._lr_range
        sign = torch.sign(g * state["prev_grad"])
        factor = torch.where(sign > 0, eta_plus,
                             torch.where(sign < 0, eta_minus, 1.0))
        lrs = torch.clamp(state["lr_per_elem"] * factor, lo, hi)
        g_eff = torch.where(sign < 0, 0.0, g)
        state["lr_per_elem"] = lrs
        state["prev_grad"] = g_eff
        return p - lrs * torch.sign(g_eff)


class ASGD(Optimizer):
    """SGD with a running average of the iterates (slot ``avg``: the mean
    of the parameters after steps 1..t)."""

    _slot_names = ("avg",)

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _update(self, p, g, state, lr, t):
        new = p - lr * g
        state["avg"] = state["avg"] + (new - state["avg"]) / float(t)
        return new
