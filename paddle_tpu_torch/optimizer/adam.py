"""Adam and AdamW (mirrors ``paddle_tpu/optimizer/adam.py:24-82``).

The update is ``adam_update``, a plain function on float32 tensors. Bias
correction at step t (t = 1 on the first step) uses pow(beta, t) in
float32, as the JAX package's ``jnp.power(float32(beta), t)`` does.
AdamW's decoupled decay comes after the Adam step and uses the old float32
parameter: p_new -= lr * wd * p32; it applies to every parameter, biases,
norms and embeddings included.
"""

from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


def _bias_correction(beta, t):
    """1 - beta**t, computed in float32."""
    return float(np.float32(1.0) - np.power(np.float32(beta), np.float32(t)))


def adam_update(p32, g32, m, v, lr, t, beta1=0.9, beta2=0.999,
                epsilon=1e-8):
    """One Adam step: returns (new p32, new m, new v), all float32."""
    m = beta1 * m + (1 - beta1) * g32
    v = beta2 * v + (1 - beta2) * g32 * g32
    m_hat = m / _bias_correction(beta1, t)
    v_hat = v / _bias_correction(beta2, t)
    return p32 - lr * m_hat / (torch.sqrt(v_hat) + epsilon), m, v


class Adam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, amsgrad=False):
        if amsgrad:
            raise NotImplementedError("amsgrad is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _update(self, p32, g32, state, lr, t):
        new, state["moment1"], state["moment2"] = adam_update(
            p32, g32, state["moment1"], state["moment2"], lr, t,
            self._beta1, self._beta2, self._epsilon)
        return new


class AdamW(Adam):
    """Decoupled weight decay (default 0.01) on every parameter."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, amsgrad=False):
        if apply_decay_param_fun is not None:
            raise NotImplementedError("apply_decay_param_fun is not ported "
                                      "yet: AdamW decays every parameter")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, amsgrad)
