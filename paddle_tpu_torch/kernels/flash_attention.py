"""Scaled-dot-product attention on the Paddle layout [B, S, H, D]
(mirrors ``paddle_tpu/kernels/flash_attention.py:93`` and the custom VJP of
``paddle_tpu/kernels/pallas/flash_attention.py:646-745``).

``scaled_dot_product_attention`` has native GQA (Hq = G * Hk; KV heads are
never expanded). Its forward is ``flash_fwd.cu``, the Hopper counterpart of
the Pallas ``_fwd_kernel`` (:281 there); when an input requires grad it goes
through ``FlashAttention``, whose backward computes Delta = rowsum(dO * O)
in PyTorch and then launches ``flash_bwd.cu``: ``flash_bwd_dq`` (the
counterpart of ``_dq_kernel``, :358) and ``flash_bwd_dkv`` (of
``_dkv_kernel``, :408). CPU tensors take the plain pair,
``flash_attention_plain`` and ``flash_attention_bwd_plain``: the same math
in plain PyTorch. ``FLAGS_flash_kernel=plain`` (read at each call) sends
CUDA tensors to the plain pair too. There is no fallback: a CUDA tensor the
kernels do not take raises.

The kernels read q/k/v/dO through their strides (the innermost one must be
1 and the others multiples of 8 elements), so the non-contiguous q/k/v
views that GPT's fused qkv projection yields are read in place; O, LSE,
dQ, dK and dV are written contiguous.

Semantics shared by all: scale 1/sqrt(D), logits in float32, masked
entries at -1e30, causal masking bottom-right aligned (query i sees keys
j <= i + Sk - Sq), a fully masked row gives O = 0, LSE = +1e30 and zero
gradients.
"""

from __future__ import annotations

import math

import torch

from ..core import flags as _flags
from ..nn.functional import dropout
from . import _build

_NEG = -1e30
_BIG = 1e30
_MODES = ("auto", "plain")


def _valid_mask(Sq, Sk, causal, device):
    if not causal:
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device=device)[None, :]
    return kj <= qi


def flash_attention_plain(q, k, v, causal=False, return_lse=False):
    """Plain PyTorch flash forward: q [B, Sq, Hq, D], k/v [B, Sk, Hk, D].
    Returns O [B, Sq, Hq, D] in q's dtype and, with ``return_lse``, LSE
    float32 [B, Hq, Sq]. Normalized probabilities are cast to V's dtype
    before P @ V, which accumulates in float32."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hq % Hk:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads "
                         f"{Hk}")
    G = Hq // Hk
    sm_scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hk, G, D).float()
    logits = torch.einsum("bsngd,btnd->bngst", qg, k.float()) * sm_scale
    valid = _valid_mask(Sq, Sk, causal, q.device)
    logits = logits.masked_fill(~valid, _NEG)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * valid
    l = p.sum(-1, keepdim=True)
    row_live = l > 0
    probs = p / torch.where(row_live, l, torch.ones_like(l))
    out = torch.einsum("bngst,btnd->bsngd", probs.to(v.dtype).float(),
                       v.float())
    out = out.reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(row_live, m + torch.log(torch.where(
        row_live, l, torch.ones_like(l))), torch.full_like(l, _BIG))
    return out, lse[..., 0].reshape(B, Hq, Sq)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False):
    """Plain PyTorch flash backward (``flash_bwd`` with ``_recompute_p``,
    ``_dq_kernel`` and ``_dkv_kernel``): returns (dQ, dK, dV) in the dtypes
    of q, k, v. P = exp(S * scale - LSE) is recomputed and masked to 0;
    Delta = rowsum(dO * O) in float32; dS = P * (dO V^T - Delta) * scale.
    The kernels' casts are kept: dO is cast to q's dtype, and to V's before
    dO V^T; dS to K's dtype for dS K and to Q's for dS^T Q; P to dO's dtype
    for P^T dO; every product accumulates in float32. dK/dV sum over the G
    query heads of a group inside the products; KV is never expanded."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    sm_scale = 1.0 / math.sqrt(D)
    do = do.to(q.dtype)
    qg = q.reshape(B, Sq, Hk, G, D)
    dog = do.reshape(B, Sq, Hk, G, D)
    delta = (do.float() * o.float()).sum(-1)                 # [B, Sq, Hq]
    delta = delta.reshape(B, Sq, Hk, G).permute(0, 2, 3, 1)[..., None]
    lse5 = lse.reshape(B, Hk, G, Sq)[..., None]
    valid = _valid_mask(Sq, Sk, causal, q.device)
    s = torch.einsum("bsngd,btnd->bngst", qg.float(), k.float()) * sm_scale
    s = s.masked_fill(~valid, _NEG)
    p = torch.where(valid, torch.exp(s - lse5), torch.zeros_like(s))
    dp = torch.einsum("bsngd,btnd->bngst", dog.to(v.dtype).float(),
                      v.float())
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum("bngst,btnd->bsngd", ds.to(k.dtype).float(),
                      k.float())
    dk = torch.einsum("bngst,bsngd->btnd", ds.to(q.dtype).float(),
                      qg.float())
    dv = torch.einsum("bngst,bsngd->btnd", p.to(do.dtype).float(),
                      dog.float())
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# -- CUDA wrappers ----------------------------------------------------------

def _check_qkv(what, q, k, v, extra=()):
    """Shapes, dtype and layout the kernels take; returns (B, Sq, Sk, Hq,
    Hk, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 4 or \
                t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} must be a 4-d bfloat16 CUDA tensor with "
                f"unit innermost stride, other strides multiples of 8 and "
                f"16-byte alignment, got {t.dtype} on {t.device} with "
                f"strides {tuple(t.stride())}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"shaped as q {tuple(q.shape)}")
    if D not in (64, 128):
        raise ValueError(f"{what}: head_dim {D} not in (64, 128)")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % Hk or 64 % (Hq // Hk):
        raise ValueError(f"{what}: GQA group {Hq}/{Hk} must be an integer "
                         f"dividing 64")
    return B, Sq, Sk, Hq, Hk, D


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def flash_fwd_cuda(q, k, v, causal=False):
    """Launch ``flash_fwd_bf16``. Returns (O, LSE), both contiguous.
    Takes bf16 [B, S, H, D] tensors (strided as ``_check_qkv`` says) with
    D in {64, 128} and a GQA group G dividing 64; raises on anything
    else."""
    B, Sq, Sk, Hq, Hk, D = _check_qkv("flash_fwd", q, k, v)
    out = torch.empty((B, Sq, Hq, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, Hq, Sq), device=q.device, dtype=torch.float32)
    lib = _build.load("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), lse.data_ptr(), B, Sq, Sk, Hq,
                             Hk, D, int(bool(causal)),
                             float(1.0 / math.sqrt(D)), *_strides(q, k, v),
                             stream)
    _build.check(err, "flash_fwd_bf16")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def flash_delta(o, do):
    """Delta = rowsum(dO * O) in float32, [B, Hq, Sq] (LSE's layout).
    Plain PyTorch, as the JAX package computes it outside its kernels."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _check_rowstats(what, B, Hq, Sq, *ts):
    for name, t in ts:
        if not t.is_cuda or t.dtype != torch.float32 or \
                tuple(t.shape) != (B, Hq, Sq) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"CUDA tensor of shape {(B, Hq, Sq)}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=False):
    """Launch ``flash_bwd_dq_bf16`` (B2): dQ [B, Sq, Hq, D] in bf16,
    contiguous. ``lse`` and ``delta`` are float32 [B, Hq, Sq]."""
    B, Sq, Sk, Hq, Hk, D = _check_qkv("flash_bwd_dq", q, k, v,
                                      (("do", do),))
    _check_rowstats("flash_bwd_dq", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    dq = torch.empty((B, Sq, Hq, D), device=q.device, dtype=q.dtype)
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Sq, Sk, Hq, Hk,
        D, int(bool(causal)), float(1.0 / math.sqrt(D)),
        *_strides(q, k, v, do), stream)
    _build.check(err, "flash_bwd_dq_bf16")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=False):
    """Launch ``flash_bwd_dkv_bf16`` (B3): (dK, dV) [B, Sk, Hk, D] in bf16,
    contiguous, each summed over the G query heads of its group."""
    B, Sq, Sk, Hq, Hk, D = _check_qkv("flash_bwd_dkv", q, k, v,
                                      (("do", do),))
    _check_rowstats("flash_bwd_dkv", B, Hq, Sq, ("lse", lse),
                    ("delta", delta))
    dk = torch.empty((B, Sk, Hk, D), device=q.device, dtype=k.dtype)
    dv = torch.empty((B, Sk, Hk, D), device=q.device, dtype=v.dtype)
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
        Sq, Sk, Hq, Hk, D, int(bool(causal)), float(1.0 / math.sqrt(D)),
        *_strides(q, k, v, do), stream)
    _build.check(err, "flash_bwd_dkv_bf16")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_cuda(q, k, v, o, lse, do, causal=False):
    """The kernel route of the backward: Delta, then B2 and B3."""
    do = do.to(q.dtype)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


# -- routing and autograd ---------------------------------------------------

def use_kernel(t):
    """True when ``t`` goes to the CUDA kernels: it lies on a GPU and
    ``FLAGS_flash_kernel`` is not ``plain``."""
    mode = str(_flags.flag("FLAGS_flash_kernel")).strip().lower()
    if mode not in _MODES:
        raise ValueError(f"FLAGS_flash_kernel must be one of {_MODES}, got "
                         f"{mode!r}")
    return t.device.type != "cpu" and mode != "plain"


def _kernel_layout(t):
    """``t`` itself if the kernels can read it through its strides, else
    a contiguous copy (autograd may hand the backward an expanded or
    transposed dO; the forward's q/k/v views are always readable)."""
    ok = t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0
    return t if ok else t.contiguous()


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (the custom VJP of the Pallas
    kernels). The forward runs B1 and saves (q, k, v, O, LSE); the
    backward computes Delta and runs B2 and B3. The route is chosen once,
    in the forward, by ``use_kernel``; on the plain route the forward runs
    ``flash_attention_plain`` (with autograd off, as inside every
    ``Function.forward``) and the backward ``flash_attention_bwd_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        kernel = use_kernel(q)
        if kernel:
            o, lse = flash_fwd_cuda(q, k, v, causal)
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = bool(causal)
        ctx.kernel = kernel
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.kernel:
            dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, _kernel_layout(do),
                                        ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   ctx.causal)
        return dq, dk, dv, None


def scaled_dot_product_attention(query, key, value, is_causal=False,
                                 dropout_p=0.0, training=True,
                                 generator=None):
    """SDPA on [batch, seq, heads, head_dim] with scale 1/sqrt(head_dim);
    key/value may have fewer heads (GQA). Goes through ``FlashAttention``:
    CUDA tensors take the flash kernels, CPU tensors the plain pair; with
    no input requiring grad (serving) autograd records nothing. Dropout, as
    on the JAX package's route, drops entries of the attention output
    (upscaled by 1/(1-p)), so the kernels stay on the path when p > 0."""
    out = FlashAttention.apply(query, key, value, bool(is_causal))
    if training and dropout_p > 0.0:
        out = dropout(out, dropout_p, training=True, generator=generator)
    return out
