"""Transformer layers (mirrors ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention``.

``TransformerEncoderLayer``, ``TransformerEncoder``, the decoder layers and
``Transformer`` are not ported yet.
"""

from __future__ import annotations

import collections

import torch
from torch import nn

from ..core.device import resolve_device
from . import functional as F
from .initializer import XavierNormal
from .layers import Linear


class MultiHeadAttention(nn.Module):
    """Multi-head attention (``paddle_tpu/nn/layer/transformer.py:24``):
    q/k/v/out projections (``Linear`` with bias, ``XavierNormal`` weights;
    k from ``kdim``, v from ``vdim`` features), heads split to
    [B, S, H, D] and attended by ``nn.functional.scaled_dot_product_
    attention`` (non-causal): the flash kernels on CUDA tensors without a
    mask, the plain masked route with ``attn_mask``. In training,
    ``dropout`` drops entries of the attention output (the mask from
    ``generator``, the default generator when None).

    ``cache``: a ``Cache`` (from ``gen_cache(key)``: empty k/v) has this
    call's k/v appended along the sequence; a ``StaticCache`` (from
    ``gen_cache(key, value, type=StaticCache)``: projected once) is used
    as it is. With a cache the call returns ``(out, new_cache)``."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None,
                 requires_grad=False):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("MultiHeadAttention takes "
                                      "weight_attr=None and bias_attr None "
                                      "or False only")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.generator = None  # dropout masks; the default generator if None
        kw = dict(bias=bias_attr is not False, weight_init=XavierNormal(),
                  device=resolve_device(device), dtype=dtype,
                  generator=generator, requires_grad=requires_grad)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        if type is MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return self.StaticCache(k, v)
        k = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return self.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], 1)
                v = torch.cat([cache.v, v], 1)
                new_cache = self.Cache(k, v)
            else:
                new_cache = None
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            is_causal=False, generator=self.generator)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None:
            return out, new_cache
        return out
