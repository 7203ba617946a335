"""Layers: ``Linear``, ``Embedding``, ``RMSNorm``, ``LayerNorm``,
``Dropout``, ``GELU``, and the containers ``Sequential`` and ``LayerList``
(``paddle_tpu/nn/layer/container.py``).

Parameters are made directly on ``device`` in ``dtype`` and drawn from an
explicit ``torch.Generator`` (which must live on the same device): an
8B-parameter model built in float32 first would leave a 32 GB transient.
``device=None`` is ``cuda`` (``core.device.resolve_device``: it raises
without a GPU); the CPU is asked for with ``device="cpu"``.
They are frozen (``requires_grad=False``) unless the caller passes
``requires_grad=True`` or calls ``model.requires_grad_(True)``: the serving
path never builds a graph.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn
from torch.nn import functional as TF

from ..core.device import resolve_device
from . import functional as F


def _normal(shape, std, device, dtype, generator, requires_grad):
    t = torch.empty(shape, device=device, dtype=dtype)
    t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t, requires_grad=requires_grad)


def _init(init, shape, *, device, dtype, generator, requires_grad,
          fan_shape=None):
    """A parameter drawn by an ``nn.initializer`` initializer."""
    return nn.Parameter(init(shape, device=device, dtype=dtype,
                             generator=generator, fan_shape=fan_shape),
                        requires_grad=requires_grad)


def _const(shape, value, device, dtype, requires_grad):
    return nn.Parameter(torch.full(shape, value, device=device, dtype=dtype),
                        requires_grad=requires_grad)


class Linear(nn.Module):
    """y = x @ W.T (+ b), W stored [out, in] (PyTorch's layout; the JAX
    package stores [in, out]). ``bias=True`` adds a zero-initialised
    bias, as ``paddle_tpu``'s ``Linear`` does by default. W is drawn
    N(0, ``std``), or by ``weight_init`` (an ``nn.initializer``
    initializer, e.g. ``XavierNormal()`` as ``paddle_tpu``'s ``Linear``
    has by default) with the fans of the JAX package's [in, out]."""

    def __init__(self, in_features, out_features, *, bias=False, std=0.02,
                 weight_init=None, device=None, dtype=None, generator=None,
                 requires_grad=False):
        super().__init__()
        device = resolve_device(device)
        shape = (out_features, in_features)
        self.weight = _normal(shape, std, device, dtype, generator,
                              requires_grad) if weight_init is None else \
            _init(weight_init, shape, device=device, dtype=dtype,
                  generator=generator, requires_grad=requires_grad,
                  fan_shape=(in_features, out_features))
        self.bias = _const((out_features,), 0.0, device, dtype,
                           requires_grad) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, std=0.02,
                 device=None, dtype=None, generator=None,
                 requires_grad=False):
        super().__init__()
        device = resolve_device(device)
        self.weight = _normal((num_embeddings, embedding_dim), std, device,
                              dtype, generator, requires_grad)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None, requires_grad=False):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.weight = _const((hidden_size,), 1.0, device, dtype,
                             requires_grad)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LayerNorm(nn.Module):
    """Weight 1, bias 0; statistics in float32
    (``paddle_tpu/nn/layer/norm.py:19``)."""

    def __init__(self, hidden_size, epsilon=1e-5, *, device=None,
                 dtype=None, requires_grad=False):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.weight = _const((hidden_size,), 1.0, device, dtype,
                             requires_grad)
        self.bias = _const((hidden_size,), 0.0, device, dtype,
                           requires_grad)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
    """``F.dropout`` (upscale in training, identity in eval); the mask
    comes from ``generator`` (the default generator when None)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, generator=self.generator)


class GELU(nn.Module):
    """GELU; the default is the exact erf form (``paddle_tpu/nn/layer/
    activation.py:19``), ``approximate=True`` the tanh form GPT uses."""

    def __init__(self, approximate=False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class Sequential(nn.Sequential):
    """Layers applied in order (``paddle_tpu/nn/layer/container.py:11``):
    positional layers are named "0", "1", ...; one ``OrderedDict`` or
    ``(name, layer)`` pairs keep their names. A slice is a new
    ``Sequential``, renumbered from "0"."""

    def __init__(self, *layers):
        if layers and isinstance(layers[0], (list, tuple)):
            layers = (OrderedDict(layers),)
        super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList):
    """A list of layers named by their index (``container.py:48``):
    ``append`` (returns the list), ``insert``, ``extend``, negative
    indices, slices (a new ``LayerList``), as ``nn.ModuleList`` has them."""
