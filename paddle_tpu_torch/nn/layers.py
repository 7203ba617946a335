"""Layers: ``Linear``, ``Embedding``, ``RMSNorm``, ``LayerNorm``, ``Dropout``.

Parameters are made directly on ``device`` in ``dtype`` and drawn from an
explicit ``torch.Generator`` (which must live on the same device): an
8B-parameter model built in float32 first would leave a 32 GB transient.
They are frozen (``requires_grad=False``) unless the caller passes
``requires_grad=True`` or calls ``model.requires_grad_(True)``: the serving
path never builds a graph.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as TF

from . import functional as F


def _normal(shape, std, device, dtype, generator, requires_grad):
    t = torch.empty(shape, device=device, dtype=dtype)
    t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t, requires_grad=requires_grad)


def _const(shape, value, device, dtype, requires_grad):
    return nn.Parameter(torch.full(shape, value, device=device, dtype=dtype),
                        requires_grad=requires_grad)


class Linear(nn.Module):
    """y = x @ W.T (+ b), W stored [out, in] (PyTorch's layout; the JAX
    package stores [in, out]). ``bias=True`` adds a zero-initialised
    bias, as ``paddle_tpu``'s ``Linear`` does by default."""

    def __init__(self, in_features, out_features, *, bias=False, std=0.02,
                 device=None, dtype=None, generator=None,
                 requires_grad=False):
        super().__init__()
        self.weight = _normal((out_features, in_features), std, device,
                              dtype, generator, requires_grad)
        self.bias = _const((out_features,), 0.0, device, dtype,
                           requires_grad) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, std=0.02,
                 device=None, dtype=None, generator=None,
                 requires_grad=False):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, device,
                              dtype, generator, requires_grad)

    def forward(self, ids):
        return TF.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None, requires_grad=False):
        super().__init__()
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
