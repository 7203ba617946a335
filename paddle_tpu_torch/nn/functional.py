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


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    if reduction == "none":
        return out
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy over ``axis`` in float32
    (``paddle_tpu/nn/functional/loss.py:34``). ``use_softmax=False`` takes
    ``input`` as probabilities (log of max(p, 1e-30)).

    Hard labels (a trailing 1 on the class axis is dropped): the loss of
    each label != ``ignore_index``, 0 for the others; with
    ``label_smoothing`` e it is (1 - e) * nll + e * mean(-log p); with
    ``weight`` [C] each is scaled by its class's weight, and the mean then
    divides by the sum of the picked weights (at least 1e-12), else by
    the count of labels kept (at least 1).

    Soft labels (``soft_label=True``, ``label`` shaped as ``input``):
    -sum(label * log p), the label smoothed to (1 - e) * label + e / C
    first; with ``weight`` each row is scaled by sum(label * weight); the
    mean is over every row."""
    if _AMP.enabled:
        (input,) = _amp_cast("cross_entropy", input)
    lf = input.float().movedim(axis, -1)
    logp = torch.log_softmax(lf, dim=-1) if use_softmax else \
        torch.log(lf.clamp_min(1e-30))
    w = None if weight is None else weight.float()
    if soft_label:
        soft = label.float().movedim(axis, -1)
        if label_smoothing > 0.0:
            soft = (1 - label_smoothing) * soft \
                + label_smoothing / logp.shape[-1]
        loss = -(soft * logp).sum(-1)
        if w is not None:
            loss = loss * (soft * w).sum(-1)
        return _reduce(loss, reduction)
    if label.dim() == input.dim():
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(-1)
    if w is not None:
        sample_w = torch.where(valid, w[safe], torch.zeros_like(nll))
        nll = nll * sample_w
        if reduction == "mean":
            return torch.where(valid, nll, torch.zeros_like(nll)).sum() \
                / sample_w.sum().clamp_min(1e-12)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return nll.sum() / valid.sum().clamp_min(1).float()
    return _reduce(nll, reduction)


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(v) * n
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _padding_pairs(padding, n, kernel, dilation, in_sizes=None, stride=None):
    """Paddle's padding forms as (lo, hi) pairs per spatial dim
    (``paddle_tpu/nn/functional/conv.py:27``): an int, per-dim ints, lo/hi
    pairs, a flat [lo0, hi0, lo1, hi1, ...] list, "VALID", or "SAME":
    pad_total = max((ceil(in / stride) - 1) * stride + k - in, 0), lo =
    pad_total // 2, hi the rest; it depends on the input size at stride
    > 1 and may be asymmetric."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            pairs = []
            if in_sizes is not None and stride is not None:
                for k, s, i in zip(kernel, stride, in_sizes):
                    total = max((-(-i // s) - 1) * s + k - i, 0)
                    pairs.append((total // 2, total - total // 2))
            else:
                for k, d in zip(kernel, dilation):
                    eff = d * (k - 1)
                    pairs.append((eff // 2, eff - eff // 2))
            return pairs
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == n and all(
            isinstance(p, (list, tuple)) and len(p) == 2 for p in padding):
        return [tuple(p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    raise ValueError(f"bad padding {padding!r} for {n} spatial dims")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-d convolution (``paddle_tpu/nn/functional/conv.py:105``): x in
    NCHW or NHWC, weight [out, in / groups, kh, kw] in either case, any
    padding form ``_padding_pairs`` takes ("SAME" resets dilation to 1).
    Uneven (lo != hi) padding is applied by ``F.pad`` before the product;
    the bias is added after it, on the output's channel axis."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    stride = _tuplize(stride, 2)
    dilation = _tuplize(dilation, 2)
    if isinstance(padding, str) and padding.upper() == "SAME":
        dilation = (1, 1)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    pads = _padding_pairs(padding, 2, weight.shape[2:], dilation,
                          in_sizes=x.shape[2:], stride=stride)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (hlo, hhi), (wlo, whi) = pads
        x = F.pad(x, (wlo, whi, hlo, hhi))
        sym = (0, 0)
    out = F.conv2d(x, weight, None, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """SDPA on [batch, seq, heads, head_dim]
    (``paddle_tpu/nn/functional/common.py:280``): without ``attn_mask``
    the flash kernels on CUDA tensors (the plain pair on CPU ones), with
    one the plain masked route (``kernels.flash_attention``'s
    ``scaled_dot_product_attention``)."""
    from ..kernels.flash_attention import scaled_dot_product_attention as sd
    return sd(query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
              is_causal=is_causal, training=training, generator=generator)


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
