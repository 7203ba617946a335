"""Weight initializers (mirrors ``paddle_tpu/nn/initializer/__init__.py``).

Each initializer is a callable ``(shape, *, device, dtype, generator,
fan_shape=None) -> Tensor``: it draws in float32 on ``device`` from
``generator`` (the default generator when None; it must live on
``device``) and casts to ``dtype``, as the JAX package draws in float32
and casts. The fans come from ``fan_shape`` when it is given, else from
``shape``. The port stores a ``Linear`` weight [out, in] where the JAX
package stores [in, out], so ``Linear`` passes ``fan_shape=(in, out)``:
``_fans`` then reads the same fan_in and fan_out on both sides.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal",
           "calculate_gain"]


def _fans(shape):
    """(fan_in, fan_out) of a parameter of the JAX package's ``shape``
    (``paddle_tpu/nn/initializer/__init__.py:70``): a 2-d [in, out] weight
    gives (in, out); a conv kernel [out, in, *k] gives (in * prod(k),
    out * prod(k))."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _f32(shape, device):
    return torch.empty(tuple(shape), device=device, dtype=torch.float32)


class Initializer:
    def __call__(self, shape, *, device=None, dtype=None, generator=None,
                 fan_shape=None):
        t = self._draw(tuple(shape), device, generator,
                       tuple(shape) if fan_shape is None else fan_shape)
        return t.to(dtype or torch.float32)

    def _draw(self, shape, device, generator, fan_shape):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, device, generator, fan_shape):
        return torch.full(shape, float(self.value), device=device,
                          dtype=torch.float32)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, device, generator, fan_shape):
        return _f32(shape, device).normal_(self.mean, self.std,
                                           generator=generator)


class TruncatedNormal(Initializer):
    """N(0, 1) truncated to [a, b] *in standard units*, then scaled by
    ``std`` and shifted by ``mean`` (``jax.random.truncated_normal``, then
    ``* std + mean``): ``std=0.02`` draws in [-0.04, 0.04]. The draw is the
    inverse CDF of a uniform on [Phi(a), Phi(b)]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, shape, device, generator, fan_shape):
        def cdf(x):
            return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
        u = _f32(shape, device).uniform_(cdf(self.a), cdf(self.b),
                                         generator=generator)
        z = torch.special.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
        return z.clamp_(self.a, self.b) * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, shape, device, generator, fan_shape):
        return _f32(shape, device).uniform_(self.low, self.high,
                                            generator=generator)


class XavierNormal(Initializer):
    """N(0, gain * sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, fan_shape):
        fi, fo = _fans(fan_shape)
        return self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                            + (self.fan_out or fo)))

    def _draw(self, shape, device, generator, fan_shape):
        return Normal(0.0, self.std(fan_shape))._draw(shape, device,
                                                      generator, fan_shape)


class XavierUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, fan_shape):
        fi, fo = _fans(fan_shape)
        return self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                            + (self.fan_out or fo)))

    def _draw(self, shape, device, generator, fan_shape):
        lim = self.limit(fan_shape)
        return Uniform(-lim, lim)._draw(shape, device, generator, fan_shape)


class KaimingNormal(Initializer):
    """N(0, gain / sqrt(fan_in)), gain from ``calculate_gain``."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def std(self, fan_shape):
        fi = self.fan_in or _fans(fan_shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return gain / math.sqrt(fi)

    def _draw(self, shape, device, generator, fan_shape):
        return Normal(0.0, self.std(fan_shape))._draw(shape, device,
                                                      generator, fan_shape)


def calculate_gain(nonlinearity, param=None):
    """The JAX package's gains (``calculate_gain``)."""
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")
