"""Optimizer base (mirrors ``paddle_tpu/optimizer/optimizer.py:54-160``).

Parameter groups (dicts with ``params`` and an optional ``weight_decay``)
carry their own weight decay. With ``multi_precision`` (the default)
a bf16/fp16 parameter gets a float32 master copy; the update runs on the
master and the parameter receives ``master.to(param dtype)``. A float32
parameter is itself the float32 copy and has no master. Moments are
float32. The learning rate is a constant: schedulers are not ported yet.
"""

from __future__ import annotations

import torch

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    # names of per-parameter float32 slots, e.g. ("moment1", "moment2")
    _slot_names: tuple = ()
    # decoupled (AdamW-style) decay instead of L2 decay folded into g
    _decoupled = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True):
        if parameters is None:
            raise ValueError("parameters is required")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedulers are not "
                                      "ported yet; pass a float")
        self._lr = float(learning_rate)
        self._groups = self._build_groups(parameters, weight_decay)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        # id(param) -> {"master": tensor or None, slot name: tensor}
        self._state: dict[int, dict] = {}
        self._global_step = 0

    @staticmethod
    def _build_groups(parameters, weight_decay):
        params = list(parameters)
        if not (params and isinstance(params[0], dict)):
            params = [{"params": params}]
        return [{"params": list(g["params"]),
                 "weight_decay": float(g.get("weight_decay") or
                                       weight_decay or 0.0)}
                for g in params]

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
                st[name] = torch.zeros(p.shape, device=p.device,
                                       dtype=torch.float32)
            self._state[id(p)] = st
        return st

    def _update(self, p32, g32, state, lr, t):
        """The update rule: float32 param and grad, the slot dict (updated
        in place), lr and step t -> the new float32 param."""
        raise NotImplementedError

    def _apply_param(self, p32, g32, state, lr, group, t):
        """Coupled L2 decay folds into the grad before the update;
        decoupled decay subtracts lr * wd * (the old p32) after it."""
        wd = group["weight_decay"]
        if wd and not self._decoupled:
            g32 = g32 + wd * p32
        new = self._update(p32, g32, state, lr, t)
        if wd and self._decoupled:
            new = new - lr * wd * p32
        return new

    @torch.no_grad()
    def _update_all(self):
        """Clip the grads (each in its own dtype), then update every
        parameter that has a grad at step ``self._global_step``."""
        t = self._global_step
        if self._grad_clip is not None:
            self._grad_clip.clip_(self._parameter_list)
        for group in self._groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self._slots_for(p)
                master = st["master"]
                p32 = master if master is not None else p.float()
                new = self._apply_param(p32, p.grad.float(), st, self._lr,
                                        group, t)
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
