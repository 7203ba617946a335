"""Parameter conversion from the JAX package's Llama, GPT and ViT.

``llama_params_from_numpy`` and ``gpt_params_from_numpy`` take the JAX
model's parameters as numpy arrays under their own names, e.g.

    named = {n: np.asarray(p._data) for n, p in jax_llama.named_parameters()}

and returns the port's ``state_dict``. Names are kept as they are. The one
layout change: ``paddle_tpu``'s ``Linear.weight`` is [in, out], the port's
is PyTorch's [out, in], so every Linear weight (Llama's ``*_proj.weight``;
GPT's ``qkv_proj``, ``out_proj``, ``fc_in``, ``fc_out``; ``lm_head``;
ViT's q/k/v/out projections, ``mlp.0``, ``mlp.3`` and ``heads``) is
transposed. ViT's ``conv_proj.weight`` is a 4-d kernel [out, in, kh, kw]
in the same layout on both sides and is copied as it is. Biases, embeddings and norm weights are copied as they are. A
missing, extra or mis-shaped name raises.

``llama_int8_params_from_numpy`` takes a Llama converted to int8 by the
JAX package's ``QAT(...).convert``: its parameters and its buffers, e.g.

    named = {n: np.asarray(t._data) for n, t in
             [*jax_llama.named_parameters(), *jax_llama.named_buffers()]}

Each converted layer's ``w_int8`` [in, out] becomes the port's
``ConvertedInt8Linear.w_int8`` [out, in]; ``w_scales`` [out] is copied.
Load the result into a port Llama converted by the port's ``QAT``.

With ``config.use_fp8`` the fp8 layers' buffers come along too: pass the
JAX model's parameters and buffers as above, and each converted layer's
``fp8_amax_x``, ``fp8_amax_w`` ([history_len]) and ``fp8_scale_x``,
``fp8_scale_w`` (0-d) are copied as they are, float32, transposing
nothing, so both packages start from the same scaling state.
"""

from __future__ import annotations

import numpy as np
import torch

from .amp.fp8 import DelayedScaling

_FP8_BUFFERS = ("fp8_amax_x", "fp8_amax_w", "fp8_scale_x", "fp8_scale_w")


def _is_linear(name):
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def expected_shapes(config):
    """The port's parameter names and shapes for ``config``."""
    d, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    kv = config.num_kv_heads * (config.hidden_size // config.num_heads)
    shapes = {"embed_tokens.weight": (v, d), "norm.weight": (d,)}
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (v, d)
    for n in range(config.num_layers):
        p = f"layers.{n}."
        shapes.update({
            p + "input_layernorm.weight": (d,),
            p + "post_attention_layernorm.weight": (d,),
            p + "self_attn.q_proj.weight": (d, d),
            p + "self_attn.k_proj.weight": (kv, d),
            p + "self_attn.v_proj.weight": (kv, d),
            p + "self_attn.o_proj.weight": (d, d),
            p + "mlp.gate_proj.weight": (i, d),
            p + "mlp.up_proj.weight": (i, d),
            p + "mlp.down_proj.weight": (d, i),
        })
    return shapes


def _is_fp8_buffer(name):
    return name.rsplit(".", 1)[-1] in _FP8_BUFFERS


def _with_fp8_buffers(shapes, config, is_linear):
    """``shapes`` plus the four fp8 buffers of each block linear (every
    Linear but the LM head) when ``config.use_fp8``."""
    if not config.use_fp8:
        return shapes
    h = DelayedScaling().amax_history_len
    out = dict(shapes)
    for name in shapes:
        if is_linear(name) and name != "lm_head.weight":
            layer = name[:-len("weight")]
            out.update({layer + "fp8_amax_x": (h,), layer + "fp8_amax_w": (h,),
                        layer + "fp8_scale_x": (), layer + "fp8_scale_w": ()})
    return out


def _convert(what, named, want, is_linear, dtype):
    missing = sorted(set(want) - set(named))
    extra = sorted(set(named) - set(want))
    if missing or extra:
        raise ValueError(f"{what}: missing {missing}, unexpected {extra}")
    out = {}
    for name, arr in named.items():
        a = np.asarray(arr)
        if is_linear(name):
            a = a.T
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(a.shape)} after "
                             f"conversion, expected {want[name]}")
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        keep = dtype is None or _is_fp8_buffer(name)  # buffers stay f32
        out[name] = t if keep else t.to(dtype)
    return out


def _int8_shapes(shapes):
    """Each Linear weight (out, in) -> ``w_int8`` (out, in) and
    ``w_scales`` (out,)."""
    out = {}
    for name, shape in shapes.items():
        if _is_linear(name):
            layer = name[:-len("weight")]
            out[layer + "w_int8"] = shape
            out[layer + "w_scales"] = shape[:1]
        else:
            out[name] = shape
    return out


def llama_int8_params_from_numpy(named, config):
    """A JAX-package Llama converted to int8 (numpy parameters and
    buffers, [in, out] ``w_int8``) -> the port's ``state_dict`` for a
    converted Llama (torch CPU tensors, [out, in] ``w_int8``);
    ``load_state_dict`` casts the floating ones to the model's dtype."""
    return _convert("llama_int8_params_from_numpy", named,
                    _int8_shapes(expected_shapes(config)),
                    lambda n: n.endswith(".w_int8"), None)


def llama_params_from_numpy(named, config, dtype=None):
    """JAX-package Llama parameters (numpy, [in, out] Linear weights) ->
    the port's ``state_dict`` (torch CPU tensors, [out, in] weights)."""
    return _convert("llama_params_from_numpy", named,
                    _with_fp8_buffers(expected_shapes(config), config,
                                      _is_linear), _is_linear, dtype)


_GPT_LINEARS = ("qkv_proj", "out_proj", "fc_in", "fc_out")


def _is_gpt_linear(name):
    return name == "lm_head.weight" or (
        name.endswith(".weight") and name.split(".")[-2] in _GPT_LINEARS)


def gpt_expected_shapes(config):
    """The port's GPT parameter names and shapes for ``config``."""
    d, f, v = config.hidden_size, config.intermediate_size, config.vocab_size
    shapes = {"wte.weight": (v, d),
              "wpe.weight": (config.max_position_embeddings, d),
              "ln_f.weight": (d,), "ln_f.bias": (d,)}
    if not config.tie_word_embeddings:
        shapes["lm_head.weight"] = (v, d)
    for n in range(config.num_layers):
        p = f"h.{n}."
        shapes.update({
            p + "ln_1.weight": (d,), p + "ln_1.bias": (d,),
            p + "attn.qkv_proj.weight": (3 * d, d),
            p + "attn.qkv_proj.bias": (3 * d,),
            p + "attn.out_proj.weight": (d, d),
            p + "attn.out_proj.bias": (d,),
            p + "ln_2.weight": (d,), p + "ln_2.bias": (d,),
            p + "mlp.fc_in.weight": (f, d), p + "mlp.fc_in.bias": (f,),
            p + "mlp.fc_out.weight": (d, f), p + "mlp.fc_out.bias": (d,),
        })
    return shapes


def gpt_params_from_numpy(named, config, dtype=None):
    """JAX-package GPT parameters (numpy, [in, out] Linear weights) -> the
    port's ``state_dict`` (torch CPU tensors, [out, in] weights)."""
    return _convert("gpt_params_from_numpy", named,
                    _with_fp8_buffers(gpt_expected_shapes(config), config,
                                      _is_gpt_linear), _is_gpt_linear, dtype)


_VIT_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj")


def _is_vit_linear(name):
    """The 2-d ``Linear`` weights of a ViT; not ``conv_proj.weight``,
    whose name ends in ``_proj.weight`` too."""
    parts = name.split(".")
    return parts[-1] == "weight" and (
        name == "heads.weight" or parts[-2] in _VIT_LINEARS or
        parts[-3:-1] in (["mlp", "0"], ["mlp", "3"]))


def vit_expected_shapes(config):
    """The port's ViT parameter names and shapes for ``config``."""
    d, c, p = config.hidden_size, config.num_classes, config.patch_size
    f = int(d * config.mlp_ratio)
    n = (config.image_size // p) ** 2 + 1
    shapes = {"class_token": (1, 1, d), "pos_embedding": (1, n, d),
              "conv_proj.weight": (d, 3, p, p), "conv_proj.bias": (d,),
              "ln.weight": (d,), "ln.bias": (d,),
              "heads.weight": (c, d), "heads.bias": (c,)}
    for i in range(config.num_layers):
        b = f"encoder.{i}."
        shapes.update({b + "ln_1.weight": (d,), b + "ln_1.bias": (d,),
                       b + "ln_2.weight": (d,), b + "ln_2.bias": (d,),
                       b + "mlp.0.weight": (f, d), b + "mlp.0.bias": (f,),
                       b + "mlp.3.weight": (d, f), b + "mlp.3.bias": (d,)})
        for proj in _VIT_LINEARS:
            a = b + "self_attention." + proj
            shapes.update({a + ".weight": (d, d), a + ".bias": (d,)})
    return shapes


def vit_params_from_numpy(named, config, dtype=None):
    """JAX-package ViT parameters (numpy, [in, out] Linear weights) -> the
    port's ``state_dict`` (torch CPU tensors, [out, in] weights)."""
    return _convert("vit_params_from_numpy", named,
                    vit_expected_shapes(config), _is_vit_linear, dtype)
