"""Vision Transformer, ViT-B/16, ViT-L/16 and ViT-H/14 (mirrors
``paddle_tpu/vision/models/vit.py``).

A patch embedding (one ``Conv2D`` with stride = kernel = patch size), a
class token and learned positions, pre-LN encoder blocks
(``MultiHeadAttention``, exact GELU), a final LayerNorm and a linear head
on the class token. Attention is non-causal over 1 + (image /
patch)^2 tokens: the flash kernels (B1 forward, B2 and B3 backward) on
the card. Parameter names equal the JAX package's
(``convert.vit_params_from_numpy`` maps them); ``Linear`` weights are
stored [out, in].
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...core.device import resolve_device
from ...nn import (GELU, Conv2D, Dropout, LayerList, LayerNorm, Linear,
                   MultiHeadAttention, Sequential)
from ...nn import functional as F
from ...nn.initializer import Constant, TruncatedNormal, XavierNormal
from ...nn.layers import _init

__all__ = ["VisionTransformer", "ViTConfig", "vit_b_16", "vit_l_16",
           "vit_h_14"]


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    attention_dropout: float = 0.0


class _EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        norm_kw = {n: kw[n] for n in ("device", "dtype", "requires_grad")}
        self.ln_1 = LayerNorm(d, **norm_kw)
        self.self_attention = MultiHeadAttention(
            d, cfg.num_heads, dropout=cfg.attention_dropout, **kw)
        self.dropout = Dropout(cfg.dropout)
        self.ln_2 = LayerNorm(d, **norm_kw)
        hidden = int(d * cfg.mlp_ratio)
        lin = dict(kw, bias=True, weight_init=XavierNormal())
        self.mlp = Sequential(
            Linear(d, hidden, **lin), GELU(), Dropout(cfg.dropout),
            Linear(hidden, d, **lin), Dropout(cfg.dropout))

    def forward(self, x):
        x = x + self.dropout(self.self_attention(self.ln_1(x)))
        return x + self.mlp(self.ln_2(x))


class VisionTransformer(nn.Module):
    """ViT. Parameters are made on ``device`` (default ``cuda``; raises
    without a GPU) in ``dtype`` (default float32) from ``generator``,
    which must live on ``device``, with the JAX package's initializers:
    ``XavierNormal`` for the conv and every linear weight, 0 for biases
    and the class token, ``TruncatedNormal(std=0.02)`` for the positions,
    LayerNorm weights 1. They are trainable unless
    ``requires_grad=False``."""

    def __init__(self, config: ViTConfig = None, *, device=None, dtype=None,
                 generator=None, requires_grad=True, **kwargs):
        super().__init__()
        config = config or ViTConfig(**kwargs)
        self.config = config
        device = resolve_device(device)
        dtype = dtype or torch.float32
        kw = dict(device=device, dtype=dtype, generator=generator,
                  requires_grad=requires_grad)
        d = config.hidden_size
        n_patches = (config.image_size // config.patch_size) ** 2
        self.conv_proj = Conv2D(3, d, config.patch_size,
                                stride=config.patch_size, **kw)
        self.class_token = _init(Constant(0.0), (1, 1, d), **kw)
        self.pos_embedding = _init(TruncatedNormal(std=0.02),
                                   (1, n_patches + 1, d), **kw)
        self.encoder = LayerList([_EncoderBlock(config, **kw)
                                  for _ in range(config.num_layers)])
        self.ln = LayerNorm(d, device=device, dtype=dtype,
                            requires_grad=requires_grad)
        self.heads = Linear(d, config.num_classes, bias=True,
                            weight_init=XavierNormal(), **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, x):
        """images [b, 3, image, image] -> logits [b, num_classes]."""
        b = x.shape[0]
        d = self.config.hidden_size
        x = self.conv_proj(x)                          # [b, d, h', w']
        x = x.reshape(b, d, -1).transpose(1, 2)        # [b, n_patches, d]
        x = torch.cat([self.class_token.expand(b, 1, d), x], 1)
        x = self.dropout(x + self.pos_embedding)
        for blk in self.encoder:
            x = blk(x)
        x = self.ln(x)
        return self.heads(x[:, 0])

    def loss(self, images, labels):
        return F.cross_entropy(self(images), labels)


def vit_b_16(**kwargs):
    """ViT-B/16; ``device``, ``dtype``, ``generator`` and
    ``requires_grad`` go to the model, the rest to ``ViTConfig``."""
    model_kw, cfg_kw = _split(kwargs)
    return VisionTransformer(ViTConfig(hidden_size=768, num_layers=12,
                                       num_heads=12, **cfg_kw), **model_kw)


def vit_l_16(**kwargs):
    model_kw, cfg_kw = _split(kwargs)
    return VisionTransformer(ViTConfig(hidden_size=1024, num_layers=24,
                                       num_heads=16, **cfg_kw), **model_kw)


def vit_h_14(**kwargs):
    model_kw, cfg_kw = _split(kwargs)
    return VisionTransformer(ViTConfig(hidden_size=1280, num_layers=32,
                                       num_heads=16, patch_size=14,
                                       **cfg_kw), **model_kw)


_MODEL_KW = ("device", "dtype", "generator", "requires_grad")


def _split(kwargs):
    model = {k: v for k, v in kwargs.items() if k in _MODEL_KW}
    return model, {k: v for k, v in kwargs.items() if k not in _MODEL_KW}
