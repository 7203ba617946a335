"""FP8 training: the scaled fp8 product, delayed scaling and the layer
(mirrors ``paddle_tpu/amp/fp8.py``).

Activations and weights are quantized to e4m3 (range +-448) with
**delayed** per-tensor scales: a layer keeps an amax history of
``amax_history_len`` steps and scales by the history's max (or its newest
entry) *before* this step's amax is rolled in; an all-zero history falls
back to the current amax. Gradients are quantized to e5m2 (+-57344) with
**current** scaling, inside the backward. Histories and scales change only
in training mode.

The product is ``fp8_gemm``: ``torch._scaled_mm`` (cuBLASLt) on a CUDA
tensor, float32 out, the per-tensor scales as 0-d float32 device tensors,
and the plain version (dequantize to float32, ``torch.matmul``, scale) on
a CPU tensor. The JAX package's product is ``jax.lax.dot_general`` on fp8
operands, an XLA dot outside any Pallas kernel, so its counterpart here is
the library's fp8 GEMM, as bf16 products are ``F.linear``. There is no
fallback: a CUDA product ``_scaled_mm`` refuses (shape, layout, dtype)
raises. ``fp8_gemm.launches`` counts the CUDA products.

Layout: the port's ``Linear`` stores W as [out, in]. ``_scaled_mm`` takes
``a`` row-major and ``b`` column-major with K and N multiples of 16. The
forward's ``wq.t()`` is already column-major; the backward's dx = gq @ wq
and dW = gq^T @ xq need transposed copies of wq, gq and xq (fp8, one
byte an element). cuBLASLt takes e4m3 x e5m2 and e5m2 x e4m3, which is
all the backward needs. Amax, the history roll and the scales stay 0-d
device tensors: nothing on this path reads a value on the host.

``convert_to_fp8(model)`` re-classes every ``Linear`` under ``model`` in
place as ``FP8Linear`` (the same ``Parameter`` objects), or build GPT and
Llama with ``use_fp8=True``. ``fp8_autocast(enabled=False)`` runs
converted layers as plain linears.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from ..nn import functional as F
from ..nn.layers import Linear

__all__ = [
    "DelayedScaling", "FP8Linear", "convert_to_fp8", "fp8_autocast",
    "fp8_enabled", "scaled_fp8_matmul", "fp8_gemm", "fp8_gemm_plain",
    "fp8_white_list", "E4M3_MAX", "E5M2_MAX",
]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

# the op names with an fp8 compute path (informational, as in the JAX
# package: conversion is opt-in through convert_to_fp8 / FP8Linear)
fp8_white_list = {"matmul", "linear", "mm", "bmm"}


@dataclasses.dataclass
class DelayedScaling:
    """Forward scales from a rolling amax history; gradient scales from
    the gradient itself."""

    margin: int = 0            # scale = amax * 2**margin / dtype_max
    amax_history_len: int = 16
    amax_compute_algo: str = "max"  # "max" | "most_recent"


class _FP8State(threading.local):
    def __init__(self):
        self.override = None  # None: the layer's default; False: off
        self.recipe = None    # the scope's recipe, over the layer's


_state = _FP8State()


@contextlib.contextmanager
def fp8_autocast(enabled=True, recipe=None):
    """Scope-gate converted layers: ``enabled=False`` runs them as plain
    linears; ``recipe`` replaces the layer's recipe inside the scope (for
    the scales computed there)."""
    prev = (_state.override, _state.recipe)
    _state.override = bool(enabled)
    _state.recipe = recipe
    try:
        yield
    finally:
        _state.override, _state.recipe = prev


def fp8_enabled(layer_default=True):
    return layer_default if _state.override is None else _state.override


def _quantize(x, scale, fp8_max, dtype):
    """clip(x_f32 * (1 / scale), +-fp8_max) cast to ``dtype``, row-major."""
    inv = 1.0 / scale
    return (x.float() * inv).clamp_(-fp8_max, fp8_max).to(
        dtype, memory_format=torch.contiguous_format)


def _amax(t):
    """max |t| as a 0-d float32 tensor (one reduction; exact)."""
    return torch.linalg.vector_norm(t.detach(), float("inf")).float()


def _transposed(t):
    """A row-major copy of the 2-d fp8 ``t``'s transpose (moved as bytes:
    a uint8 copy is there on every build)."""
    return t.view(torch.uint8).t().contiguous().view(t.dtype)


def _pad_rows(t, rows):
    """The 2-d fp8 ``t`` with zero rows appended up to ``rows``."""
    out = torch.zeros(rows, t.shape[1], dtype=torch.uint8, device=t.device)
    out[:t.shape[0]] = t.view(torch.uint8)
    return out.view(t.dtype)


def fp8_gemm(a, b, scale_a, scale_b):
    """(a @ b) * (scale_a * scale_b) in float32: ``a`` [M, K] fp8
    row-major, ``b`` [K, N] fp8 column-major, scales 0-d float32. CUDA
    tensors: one ``torch._scaled_mm``, counted in ``fp8_gemm.launches``;
    CPU tensors: ``fp8_gemm_plain``."""
    if a.device.type != "cuda":
        return fp8_gemm_plain(a, b, scale_a, scale_b)
    out = torch._scaled_mm(a, b, scale_a=scale_a, scale_b=scale_b,
                           out_dtype=torch.float32)
    fp8_gemm.launches += 1
    return out


fp8_gemm.launches = 0


def fp8_gemm_plain(a, b, scale_a, scale_b):
    """The plain version: dequantized float32 operands, ``torch.matmul``,
    then the scales, as the JAX package's f32-accumulated dot is scaled."""
    return torch.matmul(a.float(), b.float()) * (scale_a * scale_b)


def _grad_scale(g32):
    """Current scaling of a gradient: max(amax, 1e-12) / E5M2_MAX."""
    return torch.clamp_min(_amax(g32), 1e-12) / E5M2_MAX


class _ScaledMM(torch.autograd.Function):
    """x2d [M, K] @ w[N, K]^T with e4m3 operands and float32 out, times
    sx * sw (``_scaled_mm`` :99 there). The backward quantizes the
    gradient to e5m2 and multiplies it with the SAVED fp8 operands; the
    cotangents come back in the primal dtypes; the scales get none."""

    @staticmethod
    def forward(ctx, x2d, w, sx, sw):
        xq = _quantize(x2d, sx, E4M3_MAX, torch.float8_e4m3fn)
        wq = _quantize(w, sw, E4M3_MAX, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq, sx, sw)
        ctx.dtypes = (x2d.dtype, w.dtype)
        return fp8_gemm(xq, wq.t(), sx, sw)

    @staticmethod
    def backward(ctx, g):
        xq, wq, sx, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        g32 = g.float()
        sg = _grad_scale(g32)
        gq = _quantize(g32, sg, E5M2_MAX, torch.float8_e5m2)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx [M, K] = gq [M, N] @ wq [N, K]
            dx = fp8_gemm(gq, _transposed(wq).t(), sg, sw).to(x_dtype)
        if ctx.needs_input_grad[1]:
            # dW [N, K] = gq^T [N, M] @ xq [M, K]; M is this product's K,
            # so zero rows pad it to a multiple of 16 (they add nothing)
            rows = -(-xq.shape[0] // 16) * 16
            if rows != xq.shape[0]:
                gq, xq = _pad_rows(gq, rows), _pad_rows(xq, rows)
            dw = fp8_gemm(_transposed(gq), _transposed(xq).t(), sg,
                          sx).to(w_dtype)
        return dx, dw, None, None


def _fp8_linear_fn(x, w, b, sx, sw):
    """Flatten the leading dims, fp8 product, cast to x's dtype, then add
    the bias (in x's dtype, as :142-150 there)."""
    lead = x.shape[:-1]
    y = _ScaledMM.apply(x.reshape(-1, x.shape[-1]), w, sx, sw)
    y = y.reshape(*lead, w.shape[0]).to(x.dtype)
    return y if b is None else y + b


def scaled_fp8_matmul(x, y, x_scale=None, y_scale=None, name=None):
    """``x @ y`` (y [K, N]) with e4m3 operands, float32 accumulation and
    e5m2 current-scaled gradients, in x's dtype. Scales default to the
    current amax / E4M3_MAX."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)

    def scale(t, s):
        if s is not None:
            return torch.as_tensor(s, dtype=torch.float32, device=t.device)
        return torch.clamp_min(_amax(t), 1e-12) / E4M3_MAX

    sx, sy = scale(x, x_scale), scale(y, y_scale)
    lead = x.shape[:-1]
    out = _ScaledMM.apply(x.reshape(-1, x.shape[-1]), y.t(), sx, sy)
    return out.reshape(*lead, y.shape[-1]).to(x.dtype)


def _delayed_scale(history, cur_amax, fp8_max, margin, algo):
    """This step's scale from the history (before ``cur_amax`` is rolled
    in); an all-zero history falls back to the current amax. float32."""
    amax = history[0] if algo == "most_recent" else history.max()
    amax = torch.where(amax > 0.0, amax, cur_amax)
    amax = torch.clamp_min(amax, 1e-12)
    return amax * float(2.0 ** margin) / fp8_max


@torch.no_grad()
def _update_scales(layer, x, recipe):
    """(sx, sw) for this forward of ``layer``; in training mode the
    histories roll (newest first) and the scale buffers take the new
    scales, in place."""
    cur_x, cur_w = _amax(x), _amax(layer.weight)
    hx, hw = layer.fp8_amax_x, layer.fp8_amax_w
    sx = _delayed_scale(hx, cur_x, E4M3_MAX, recipe.margin,
                        recipe.amax_compute_algo)
    sw = _delayed_scale(hw, cur_w, E4M3_MAX, recipe.margin,
                        recipe.amax_compute_algo)
    if layer.training:
        hx.copy_(torch.cat([cur_x.view(1), hx[:-1]]))
        hw.copy_(torch.cat([cur_w.view(1), hw[:-1]]))
        layer.fp8_scale_x.copy_(sx)
        layer.fp8_scale_w.copy_(sw)
    return sx, sw


def _init_fp8_state(layer, recipe):
    layer.fp8_recipe = recipe or DelayedScaling()
    h = layer.fp8_recipe.amax_history_len
    dev = layer.weight.device
    layer.register_buffer("fp8_amax_x", torch.zeros(h, device=dev))
    layer.register_buffer("fp8_amax_w", torch.zeros(h, device=dev))
    layer.register_buffer("fp8_scale_x", torch.ones((), device=dev))
    layer.register_buffer("fp8_scale_w", torch.ones((), device=dev))


class FP8Linear(Linear):
    """``Linear`` with fp8 compute: the same parameters, plus the buffers
    ``fp8_amax_x``/``fp8_amax_w`` (histories, float32 [history_len]) and
    ``fp8_scale_x``/``fp8_scale_w`` (the last training step's scales)."""

    def __init__(self, in_features, out_features, *, recipe=None, **kw):
        super().__init__(in_features, out_features, **kw)
        _init_fp8_state(self, recipe)

    def forward(self, x):
        if not fp8_enabled():
            return F.linear(x, self.weight, self.bias)
        sx, sw = _update_scales(self, x, _state.recipe or self.fp8_recipe)
        return _fp8_linear_fn(x, self.weight, self.bias, sx, sw)


def convert_to_fp8(model, recipe=None, include=None, exclude=()):
    """Re-class every ``Linear`` under ``model`` (exactly that type) as
    ``FP8Linear`` in place, keeping its ``Parameter`` objects.
    ``include``: a predicate or name substrings that restrict conversion;
    ``exclude``: name substrings to skip (e.g. ``("lm_head",)``)."""

    def want(name):
        if any(e in name for e in exclude):
            return False
        if include is None:
            return True
        if callable(include):
            return include(name)
        return any(i in name for i in include)

    def walk(layer, prefix=""):
        for name, sub in list(layer.named_children()):
            full = f"{prefix}.{name}" if prefix else name
            if type(sub) is Linear and want(full):
                sub.__class__ = FP8Linear
                _init_fp8_state(sub, recipe)
            else:
                walk(sub, full)
    walk(model)
    return model
