"""Functional layer math (mirrors ``paddle_tpu/nn/functional``).

Weights of ``linear`` are in PyTorch's [out, in] layout; ``convert.py``
transposes the JAX package's [in, out] weights on the way in. The flash
attention functions import ``kernels.flash_attention`` inside their
bodies: that module imports ``dropout`` from here.

Under ``amp.auto_cast`` the ops named in the AMP lists cast their inputs
first (``amp.cast_args``): ``linear`` and ``matmul`` to the AMP dtype,
``layer_norm``, ``rms_norm``, ``softmax`` and ``cross_entropy`` to float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp import _state as _AMP
from ..amp import cast_args as _amp_cast


def linear(x, weight, bias=None):
    """y = x @ weight.T + bias, ``weight`` [out, in]."""
    if _AMP.enabled:
        x, weight, bias = _amp_cast("linear", x, weight, bias)
    return F.linear(x, weight, bias)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """x @ y, either operand transposed over its last two axes first."""
    if _AMP.enabled:
        x, y = _amp_cast("matmul", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def softmax(x, axis=-1):
    """Softmax over ``axis`` in ``x``'s dtype."""
    if _AMP.enabled:
        (x,) = _amp_cast("softmax", x)
    return torch.softmax(x, dim=axis)


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm computed in float32 and cast back to ``x.dtype``
    (``paddle_tpu/nn/functional/common.py:143``)."""
    if _AMP.enabled:
        x, weight = _amp_cast("rms_norm", x, weight)
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims: mean and
    biased variance in float32, output cast back to ``x.dtype``
    (``paddle_tpu/nn/functional/common.py:113``)."""
    if _AMP.enabled:
        x, weight, bias = _amp_cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def swiglu(gate, up):
    """silu(gate) * up (``paddle_tpu/nn/functional/activation.py:178``)."""
    return F.silu(gate) * up


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form of ``jax.nn.gelu``,
    the one GPT uses (``paddle_tpu/nn/functional/activation.py:28``)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, training=True, generator=None):
    """Dropout in ``upscale_in_train`` mode, its mask drawn from
    ``generator`` (``paddle_tpu/nn/functional/common.py:66``): kept
    entries are scaled by 1/(1-p) in training; the identity in eval."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) \
        < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x)).to(x.dtype)


def cross_entropy(logits, label, ignore_index=-100):
    """Hard-label softmax cross entropy over the last axis, in float32,
    averaged over the labels != ``ignore_index`` (at least 1)
    (``paddle_tpu/nn/functional/loss.py:34``)."""
    if _AMP.enabled:
        (logits,) = _amp_cast("cross_entropy", logits)
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1).float()


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, name=None,
                    generator=None):
    """Flash attention on [batch, seq, heads, head_dim] with dropout on the
    output (``paddle_tpu/nn/functional/common.py:292``). Returns (out,
    None)."""
    from ..kernels.flash_attention import scaled_dot_product_attention
    out = scaled_dot_product_attention(query, key, value, is_causal=causal,
                                       dropout_p=dropout, training=training,
                                       generator=generator)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """Varlen flash attention on packed [total_tokens, heads, head_dim]
    inputs with ``cu_seqlens`` prefix sums
    (``paddle_tpu/nn/functional/common.py:301``). Returns (out, None)."""
    from ..kernels.flash_attention import flash_attn_unpadded as fa
    return fa(query, key, value, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
              max_seqlen_k, scale, dropout=dropout, causal=causal,
              return_softmax=return_softmax, training=training,
              generator=generator)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False,
                                fixed_seed_offset=None, rng_name="",
                                varlen_padded=True, training=True,
                                name=None, generator=None):
    """``flash_attn_unpadded`` on qkv [total, 3, heads, head_dim]
    (``paddle_tpu/nn/functional/extra.py:608``); q, k and v are read in
    place as views. Returns (out, None)."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2],
                               cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                               max_seqlen_k, scale, dropout=dropout,
                               causal=causal, training=training,
                               generator=generator)
