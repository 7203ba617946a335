"""Weight-only int8 quantization and the int8 row primitives (mirrors
``paddle_tpu/quantization/__init__.py``).

- Row primitives (``absmax_row_scales``, ``quantize_rows``,
  ``dequantize_rows``): symmetric per-row absmax int8 over the last axis,
  computed in float32 with a 1e-8 scale floor. The int8 KV cache
  (``inference/paged.py``, ``FLAGS_kv_cache_dtype=int8``) stores one scale
  per (token, kv head) row with them.
- QAT: ``QAT(QuantConfig(activation=None,
  weight=FakeQuanterWithAbsMaxObserver)).quantize(model)`` swaps every
  ``Linear`` for a ``QuantedLinear`` (fake-quantized weights, straight-
  through gradient); ``.convert(model)`` swaps each ``QuantedLinear`` for
  a ``ConvertedInt8Linear``: int8 weights [out, in] with per-output-channel
  scales, whose forward is the int8 weight matmul
  (``kernels/quant_matmul.py``).

Weight scales are computed in the weight's dtype, with their own 1e-9
floor (``AbsMaxChannelWiseWeightObserver``), so a bf16 model keeps bf16
scales, as the JAX package does. ``convert`` reads ``FLAGS_paged_kernel``
once per layer: ``auto``/``kernel`` launch the CUDA kernel for CUDA
tensors (its plain version for CPU tensors); ``dense`` always takes the
plain version.

Not ported yet: ``PTQ``, the activation observers (``AbsmaxObserver``,
``PercentileObserver``) and the conv forms.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..nn import Linear

__all__ = ["QMAX_INT8", "absmax_row_scales", "quantize_rows",
           "dequantize_rows", "BaseObserver", "BaseQuanter",
           "AbsMaxChannelWiseWeightObserver",
           "FakeQuanterWithAbsMaxObserver", "quanter", "QuantConfig",
           "QuantedLinear", "ConvertedInt8Linear", "QAT"]

QMAX_INT8 = 127.0
_SCALE_FLOOR = 1e-8  # an all-zero row quantizes (and dequantizes) to 0


# ---------------------------------------------------------------------------
# int8 row primitives
# ---------------------------------------------------------------------------

def absmax_row_scales(x, qmax=QMAX_INT8):
    """Per-row absmax scales over the last axis: float32, shape
    ``x.shape[:-1]``, floored at 1e-8."""
    a = x.float().abs().amax(dim=-1)
    return torch.clamp_min(a / qmax, _SCALE_FLOOR)


def quantize_rows(x, qmax=QMAX_INT8):
    """-> (int8 tensor of ``x.shape``, float32 scales of ``x.shape[:-1]``):
    symmetric per-row absmax quantization, rounding half to even."""
    s = absmax_row_scales(x, qmax)
    q = torch.clamp(torch.round(x.float() / s[..., None]), -qmax, qmax)
    return q.to(torch.int8), s


def dequantize_rows(q, scales, dtype=torch.float32):
    """Inverse of :func:`quantize_rows` (``scales`` broadcast over the last
    axis), returned in ``dtype``."""
    return (q.float() * scales[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# observers / quanters
# ---------------------------------------------------------------------------

class BaseObserver(nn.Module):
    """Collects statistics in forward and yields scales."""

    quant_bits = 8

    def forward(self, x):
        return x

    def scales(self):
        raise NotImplementedError

    @property
    def qmax(self):
        return float(2 ** (self.quant_bits - 1) - 1)


class BaseQuanter(BaseObserver):
    """Fake-quantizes in forward."""


class AbsMaxChannelWiseWeightObserver(BaseObserver):
    """Per-output-channel weight scales: absmax over every other axis /
    qmax, in the weight's dtype, floored at 1e-9."""

    def __init__(self, quant_bits=8):
        super().__init__()
        self.quant_bits = quant_bits
        self._scales = None

    def observe_weight(self, w, channel_axis):
        axes = tuple(i for i in range(w.dim()) if i != channel_axis)
        s = w.abs().amax(dim=axes) / self.qmax
        self._scales = torch.clamp_min(s, 1e-9)
        return self._scales

    def scales(self):
        return self._scales


class FakeQuanterWithAbsMaxObserver(BaseQuanter):
    """Fake quantization against a moving-average absmax: in training the
    scale starts at the first batch's absmax and then moves by
    ``moving_rate``; the forward rounds to ``bit_length`` bits and passes
    the gradient straight through."""

    def __init__(self, moving_rate=0.9, bit_length=8, dtype="float32",
                 name=None):
        super().__init__()
        self.moving_rate = moving_rate
        self.bit_length = bit_length
        self.quant_bits = bit_length
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        # a buffer, so that a restored QAT model keeps its trained scale
        # valid for convert() without another batch
        self.register_buffer("accum_state",
                             torch.zeros((), dtype=torch.float32))

    @property
    def _initialized(self):
        return float(self.accum_state) != 0.0

    def forward(self, x):
        qmax = float(2 ** (self.bit_length - 1) - 1)
        if self.training:
            cur = float(x.detach().abs().max())
            if not self._initialized:
                new_scale = cur
                self.accum_state.fill_(1.0)
            else:
                new_scale = (self.moving_rate * float(self.scale) +
                             (1 - self.moving_rate) * cur)
            self.scale.fill_(new_scale)
        s = max(float(self.scale), 1e-9)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        deq = q * s / qmax
        return x + (deq - x).detach()

    def scales(self):
        if not self._initialized:
            # the initial 1.0 is not a real scale: convert() then keeps
            # activations unquantized
            return None
        return float(self.scale) / self.qmax


_QUANTER_REGISTRY = {}


def quanter(name):
    """Class decorator registering a quanter under a config name."""

    def wrap(cls):
        _QUANTER_REGISTRY[name] = cls
        return cls
    return wrap


quanter("FakeQuanterWithAbsMaxObserver")(FakeQuanterWithAbsMaxObserver)


class QuantConfig:
    """Maps layer types to (activation, weight) quanter factories; a
    factory is a class, a callable, or a registered name."""

    def __init__(self, activation=None, weight=None):
        self.activation = self._resolve(activation)
        self.weight = self._resolve(weight)
        self._type_configs = {}

    @staticmethod
    def _resolve(q):
        if isinstance(q, str):
            return _QUANTER_REGISTRY[q]
        return q

    def add_type_config(self, layer_type, activation=None, weight=None):
        for t in (layer_type if isinstance(layer_type, (list, tuple))
                  else [layer_type]):
            self._type_configs[t] = (self._resolve(activation),
                                     self._resolve(weight))

    def _quanters_for(self, layer):
        for t, (a, w) in self._type_configs.items():
            if isinstance(layer, t):
                return a, w
        return self.activation, self.weight


def _instantiate(q):
    return q() if callable(q) and not isinstance(q, nn.Module) else q


class QuantedLinear(nn.Module):
    """QAT form of a ``Linear``: fake-quantized activations and weights,
    sharing the source layer's parameters."""

    def __init__(self, linear, a_quanter, w_quanter):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        self.a_quanter = _instantiate(a_quanter)
        self.w_quanter = _instantiate(w_quanter)

    def forward(self, x):
        if self.a_quanter is not None:
            x = self.a_quanter(x)
        w = self.weight
        if self.w_quanter is not None:
            w = self.w_quanter(w)
        return torch.nn.functional.linear(x, w, self.bias)


# ---------------------------------------------------------------------------
# deployment form
# ---------------------------------------------------------------------------

def _act_fake_quant(x, scale):
    """Static input quantization at the deployed layer's edge."""
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def _quantize_weight(w, channel_axis):
    """-> (int8 weights, per-channel scales in ``w``'s dtype)."""
    scales = AbsMaxChannelWiseWeightObserver().observe_weight(
        w, channel_axis)
    shape = [1] * w.dim()
    shape[channel_axis] = -1
    q = torch.clamp(torch.round(w / scales.reshape(shape)), -127, 127)
    return q.to(torch.int8), scales


class ConvertedInt8Linear(nn.Module):
    """Deployment form: ``w_int8`` [out, in] (K-contiguous, PyTorch's
    ``Linear`` layout; the JAX package stores [in, out]) and ``w_scales``
    [out] in the source weight's dtype, plus an optional static activation
    scale. The route is ``FLAGS_paged_kernel``, read once here, and, per
    call, ``kernels.quant_matmul.int8_linear``: with K a multiple of 16
    bf16, fp16 and float32 x take the tensor-core kernels on the card
    (float32 as three bf16 pieces), any other x the CUDA cores'
    ``quant_matmul_simt`` (each call counted in that module's
    ``ROUTE_COUNTS``); the
    float32 copy of the scales the kernel reads (``w_scales_f32``, not
    saved) is made here and remade from ``w_scales`` whenever those are
    loaded or moved (``load_state_dict``, ``.to()``). The output is in
    ``x.dtype`` on both routes."""

    def __init__(self, src, act_scale=None):
        super().__init__()
        from ..inference.paged import resolve_paged_kernel
        with torch.no_grad():
            q, scales = _quantize_weight(src.weight.detach(), channel_axis=0)
        self.register_buffer("w_int8", q)
        self.register_buffer("w_scales", scales)
        self.register_buffer("w_scales_f32", scales.float(),
                             persistent=False)
        self.bias = src.bias
        self.act_scale = act_scale
        self.kernel_mode = resolve_paged_kernel(None)
        self.register_load_state_dict_post_hook(
            lambda module, _: module._sync_scales())

    def _sync_scales(self):
        self.w_scales_f32 = self.w_scales.float()

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        self._sync_scales()  # a dtype cast must not reach the kernel's copy
        return self

    def forward(self, x):
        from ..kernels.quant_matmul import int8_linear
        if self.act_scale is not None:
            x = _act_fake_quant(x, self.act_scale)
        out = int8_linear(x, self.w_int8, self.w_scales_f32,
                          self.kernel_mode)
        return out + self.bias if self.bias is not None else out


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

class QAT:
    """``quantize()`` swaps each ``Linear`` the config opts in for a
    ``QuantedLinear``; train; ``convert()`` swaps each ``QuantedLinear``
    for a ``ConvertedInt8Linear``. Both copy the model first unless
    ``inplace=True`` (an 8B model converted in place never holds its bf16
    and int8 weights together)."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model, inplace=False):
        target = model if inplace else copy.deepcopy(model)
        self._swap(target)
        return target

    def _swap(self, layer):
        for name, sub in list(layer.named_children()):
            a, w = self.config._quanters_for(sub)
            if isinstance(sub, Linear) and (a or w):
                setattr(layer, name, QuantedLinear(sub, a, w))
            else:
                self._swap(sub)

    def convert(self, model, inplace=False):
        target = model if inplace else copy.deepcopy(model)
        self._convert(target)
        return target

    @staticmethod
    def _act_scale(sub):
        q = getattr(sub, "a_quanter", None)
        if isinstance(q, BaseObserver):
            try:
                s = q.scales()
            except NotImplementedError:
                return None
            return float(s) if s is not None else None
        return None

    def _convert(self, layer):
        for name, sub in list(layer.named_children()):
            if isinstance(sub, QuantedLinear):
                setattr(layer, name,
                        ConvertedInt8Linear(sub, self._act_scale(sub)))
            else:
                self._convert(sub)
