"""The Adam family (mirrors ``paddle_tpu/optimizer/adam.py``): Adam (with
``amsgrad``), AdamW, Adamax, NAdam, RAdam and Lamb.

Step-dependent scalars (bias corrections 1 - beta**t, NAdam's momentum
schedule, RAdam's rectification) are computed on the host in float32, as
the JAX package's ``jnp.power(float32(beta), t)`` computes them; the
tensors are float32. AdamW's decoupled decay comes after the Adam step
and uses the old float32 parameter: p_new -= lr * wd * p32, on every
parameter unless ``apply_decay_param_fun(name)`` says no (the name it was
given to the optimizer with, "" if none).
"""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

_F32 = np.float32


def _pow(base, t):
    """base**t in float32."""
    return np.power(_F32(base), _F32(t))


def _bias_correction(beta, t):
    """1 - beta**t, computed in float32."""
    return float(_F32(1.0) - _pow(beta, t))


class Adam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = amsgrad
        if amsgrad:
            self._slot_names = self._slot_names + ("moment2_max",)

    def _update(self, p, g, state, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        state["moment1"] = m
        state["moment2"] = v
        if self._amsgrad:
            v = torch.maximum(state["moment2_max"], v)
            state["moment2_max"] = v
        m_hat = m / _bias_correction(b1, t)
        v_hat = v / _bias_correction(b2, t)
        return p - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)


class AdamW(Adam):
    """Decoupled weight decay (default 0.01). ``apply_decay_param_fun(name)``
    picks the parameters that decay; ``lr_ratio(param)`` scales a
    parameter's rate (its Adam step and its decay), as the reference's
    AdamW does; the JAX package accepts ``lr_ratio`` and ignores it."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, amsgrad)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _wants_decay(self, param):
        if self._apply_decay_param_fun is None or param is None:
            return True
        return bool(self._apply_decay_param_fun(self._name(param)))

    def _apply_param(self, p32, g32, state, lr, group, t, param=None):
        if self._lr_ratio is not None and param is not None:
            lr = lr * float(self._lr_ratio(param))
        return super()._apply_param(p32, g32, state, lr, group, t, param)


class Adamax(Optimizer):
    _slot_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon

    def _update(self, p, g, state, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(g))
        state["moment"] = m
        state["inf_norm"] = u
        return p - (lr / _bias_correction(b1, t)) * m / (u + self._epsilon)


class NAdam(Optimizer):
    """Nesterov Adam with the momentum schedule
    mu_t = beta1 * (1 - 0.5 * 0.96**(t * momentum_decay)); ``mu_product``
    is a 0-d slot."""

    _slot_names = ("moment1", "moment2", "mu_product")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon
        self._psi = momentum_decay

    def _init_slot(self, name, p):
        if name == "mu_product":
            return torch.ones((), device=p.device, dtype=torch.float32)
        return super()._init_slot(name, p)

    def _mu(self, t):
        return float(_F32(self._beta1) * (
            _F32(1.0) - _F32(0.5) * _pow(0.96, _F32(t) * _F32(self._psi))))

    def _update(self, p, g, state, lr, t):
        b1, b2 = self._beta1, self._beta2
        mu_t, mu_t1 = self._mu(t), self._mu(t + 1)
        mu_product = state["mu_product"] * mu_t
        state["mu_product"] = mu_product
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        state["moment1"] = m
        state["moment2"] = v
        m_hat = (mu_t1 * m / (1 - mu_product * mu_t1) +
                 (1 - mu_t) * g / (1 - mu_product))
        v_hat = v / _bias_correction(b2, t)
        return p - lr * m_hat / (torch.sqrt(v_hat) + self._epsilon)


class RAdam(Optimizer):
    """Rectified Adam: the variance-rectified step while rho_t > 5, the
    momentum step before that."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon

    def _update(self, p, g, state, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        state["moment1"] = m
        state["moment2"] = v
        b2t = _pow(b2, t)
        m_hat = m / _bias_correction(b1, t)
        rho_inf = _F32(2.0 / (1 - b2) - 1)
        rho_t = rho_inf - _F32(2) * _F32(t) * b2t / (_F32(1) - b2t)
        if not rho_t > 5.0:
            return p - lr * m_hat
        rect = np.sqrt(max(
            (rho_t - 4) * (rho_t - 2) * rho_inf /
            max((rho_inf - 4) * (rho_inf - 2) * rho_t, _F32(1e-12)),
            _F32(0)))
        var = torch.sqrt(torch.clamp_min(v / float(_F32(1) - b2t), 0.0)) \
            + self._epsilon
        return p - lr * float(rect) * m_hat / var


class Lamb(Optimizer):
    """Layer-adaptive Adam: the Adam direction plus decoupled decay, scaled
    by the trust ratio ||p|| / ||update|| (1 when either is 0);
    ``exclude_from_weight_decay_fn(param)`` turns the decay off for a
    parameter."""

    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._wd = lamb_weight_decay
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn
        self._cur_param = None

    def _apply_param(self, p32, g32, state, lr, group, t, param=None):
        self._cur_param = param
        return super()._apply_param(p32, g32, state, lr, group, t, param)

    def _update(self, p, g, state, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        state["moment1"] = m
        state["moment2"] = v
        m_hat = m / _bias_correction(b1, t)
        v_hat = v / _bias_correction(b2, t)
        r = m_hat / (torch.sqrt(v_hat) + self._epsilon)
        wd = self._wd
        if self._exclude_fn is not None and self._cur_param is not None \
                and self._exclude_fn(self._cur_param):
            wd = 0.0
        upd = r + wd * p
        w_norm = torch.linalg.vector_norm(p)
        u_norm = torch.linalg.vector_norm(upd)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        return p - lr * trust * upd
