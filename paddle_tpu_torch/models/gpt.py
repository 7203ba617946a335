"""GPT-2 family (mirrors ``paddle_tpu/models/gpt.py:24-196``).

Pre-LN residual blocks, learned positional embeddings, tanh GELU, one
weight-tied [vocab, d] embedding for the lookup and the LM head. Attention
goes through ``scaled_dot_product_attention``: the flash forward and
backward CUDA kernels on the card. ``loss`` takes the blockwise fused
LM-head cross entropy by default (``fused_head_ce``), so the [b, s, V]
logits never exist. Parameter names equal the JAX package's
(``convert.gpt_params_from_numpy`` maps them); ``Linear`` weights are
stored [out, in]. ``use_fp8`` re-classes the block linears (not the LM
head) as ``amp.fp8.FP8Linear`` after every parameter is drawn, so a
model's weights do not depend on it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..amp.fp8 import convert_to_fp8
from ..core.device import resolve_device
from ..kernels.flash_attention import scaled_dot_product_attention
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn import functional as F
from ..nn.fused_ce import fused_linear_cross_entropy


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304  # padded to a 128-multiple
    max_position_embeddings: int = 1024
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = None
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_fp8: bool = False
    fused_head_ce: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def gpt2_small():
        return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def gpt2_medium():
        return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16)

    @staticmethod
    def gpt2_large():
        return GPTConfig(hidden_size=1280, num_layers=36, num_heads=20)

    @staticmethod
    def tiny():  # test-sized
        return GPTConfig(vocab_size=256, max_position_embeddings=64,
                         hidden_size=64, num_layers=2, num_heads=4)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        d, h = config.hidden_size, config.num_heads
        self.num_heads = h
        self.head_dim = d // h
        std = config.initializer_range
        proj_std = std / math.sqrt(2 * config.num_layers)
        self.qkv_proj = Linear(d, 3 * d, bias=True, std=std, **kw)
        self.out_proj = Linear(d, d, bias=True, std=proj_std, **kw)
        self.dropout = config.dropout
        self.generator = None  # dropout masks; the default generator if None

    def forward(self, x):
        b, s, d = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        # strided views: the kernels read them in place
        q, k, v = qkv.unbind(2)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0,
            generator=self.generator)
        return self.out_proj(out.reshape(b, s, d))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        d = config.hidden_size
        std = config.initializer_range
        proj_std = std / math.sqrt(2 * config.num_layers)
        self.fc_in = Linear(d, config.intermediate_size, bias=True, std=std,
                            **kw)
        self.fc_out = Linear(config.intermediate_size, d, bias=True,
                             std=proj_std, **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        norm_kw = {n: kw[n] for n in ("device", "dtype", "requires_grad")
                   if n in kw}
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps, **norm_kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, eps, **norm_kw)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = Dropout(config.dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPT(nn.Module):
    """GPT-2. Parameters are made on ``device`` (default ``cuda``; raises
    without a GPU) in ``dtype`` (default float32), weights drawn N(0,
    initializer_range) (the residual projections N(0, initializer_range /
    sqrt(2 * num_layers))) from ``generator``, which must live on
    ``device``; biases 0, LayerNorm weights 1. They are trainable unless
    ``requires_grad=False``."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator=None, requires_grad=True):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype or torch.float32
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator,
                  requires_grad=requires_grad)
        std = config.initializer_range
        d = config.hidden_size
        self.wte = Embedding(config.vocab_size, d, std=std, **kw)
        self.wpe = Embedding(config.max_position_embeddings, d, std=std,
                             **kw)
        self.drop = Dropout(config.dropout)
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(d, config.layer_norm_epsilon, device=device,
                              dtype=dtype, requires_grad=requires_grad)
        self.lm_head = None if config.tie_word_embeddings else Linear(
            d, config.vocab_size, std=std, **kw)
        if config.use_fp8:
            # the block linears in fp8, the LM head not (loss fidelity)
            convert_to_fp8(self, exclude=("lm_head",))

    def head_weight(self):
        """The LM head's [vocab, d] weight: ``wte``'s when tied."""
        return self.wte.weight if self.lm_head is None \
            else self.lm_head.weight

    def forward_hidden(self, input_ids):
        """Transformer stack output (post ln_f), before the LM head."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for block in self.h:
            x = block(x)
        return self.ln_f(x)

    def forward(self, input_ids):
        """ids [b, s] -> logits [b, s, vocab]."""
        return F.linear(self.forward_hidden(input_ids), self.head_weight())

    def loss(self, input_ids, labels):
        """Next-token cross entropy; ``labels`` equal to ``input_ids`` or
        already aligned with them (shifted here). The fused head slices the
        hidden states, not the logits."""
        if self.config.fused_head_ce:
            x = self.forward_hidden(input_ids)[:, :-1, :]
            return fused_linear_cross_entropy(x, self.head_weight(),
                                              labels[:, 1:],
                                              transpose_weight=True)
        logits = self(input_ids)
        return F.cross_entropy(logits[:, :-1, :], labels[:, 1:])

    def num_params(self, non_embedding=True):
        n = sum(p.numel() for p in self.parameters())
        if non_embedding:
            n -= self.wpe.weight.numel()
        return n

    def flops_per_token(self, seq_len):
        """Approximate training FLOPs per token (forward + backward),
        PaLM-style 6N + attention."""
        n = self.num_params()
        l, d = self.config.num_layers, self.config.hidden_size
        return 6 * n + 12 * l * d * seq_len

    @staticmethod
    def tp_placement_rules(mesh, tp_axis="tp"):
        raise NotImplementedError("tensor-parallel placement is not ported "
                                  "yet")
