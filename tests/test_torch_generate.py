"""PyTorch port: dense generation (the contiguous KV cache, ``generate``)
against the JAX package on the CPU.

``LlamaConfig.tiny()`` and ``GPTConfig.tiny()`` in float32, parameters
moved from the JAX models through ``convert``, prompts from numpy with a
seed. The cached forward's logits and caches within 1e-5; greedy tokens
equal. Sampled generation draws from a ``torch.Generator`` (the JAX
package from ``jax.random``), so only its shape and eos contract are
compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.convert import (gpt_params_from_numpy,
                                      llama_params_from_numpy)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

ATOL = 1e-5


def _named(layer):
    return {n: np.asarray(p._data) for n, p in layer.named_parameters()}


def _port_cfg(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def llamas():
    cfg = jllama.LlamaConfig.tiny()
    paddle.seed(0)
    jm = jllama.Llama(cfg)
    jm.eval()
    port = tllama.Llama(_port_cfg(tllama.LlamaConfig, cfg), device="cpu")
    port.load_state_dict(llama_params_from_numpy(_named(jm), cfg))
    return jm, port


def _prompts(seed, b=2, s=7):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int64)


def test_cached_forward_matches_over_prefill_and_decode(llamas):
    """A prefill of 7 positions and three single-token decode positions
    through ``forward(ids, caches, position_offset)``: logits and every
    layer's K/V caches."""
    jm, port = llamas
    ids = _prompts(1)
    nxt = _prompts(2, s=3)
    jc = jm.init_cache(2, 12)
    tc = port.init_cache(2, 12)
    steps = [(ids, 0)] + [(nxt[:, i:i + 1], 7 + i) for i in range(3)]
    for tok, off in steps:
        jl, jc = jm(paddle.to_tensor(tok), caches=jc, position_offset=off)
        tl, tc = port(torch.from_numpy(tok), caches=tc, position_offset=off)
        np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(),
                                   atol=ATOL)
        for (jk, jv), (tk, tv) in zip(jc, tc):
            np.testing.assert_allclose(tk.numpy(), jk.numpy(), atol=ATOL)
            np.testing.assert_allclose(tv.numpy(), jv.numpy(), atol=ATOL)
    # the last position's logits equal a dense forward's over the whole
    # sequence
    full = np.concatenate([ids, nxt], axis=1)
    dense = port(torch.from_numpy(full)).detach().numpy()
    np.testing.assert_allclose(tl.detach().numpy()[:, -1], dense[:, -1],
                               atol=ATOL)


def test_init_cache_shapes_and_dtypes(llamas):
    _, port = llamas
    cfg = port.config
    caches = port.init_cache(3, 20)
    assert len(caches) == cfg.num_layers
    for k, v in caches:
        assert k.shape == v.shape == (3, 20, cfg.num_kv_heads, cfg.head_dim)
        assert k.dtype == v.dtype == torch.float32
        assert not k.any() and not v.any()
    k, _ = port.init_cache(1, 4, dtype=torch.bfloat16)[0]
    assert k.dtype == torch.bfloat16


@pytest.mark.parametrize("use_cache,new", [(True, 9), (False, 3)])
def test_greedy_generate_matches(llamas, use_cache, new):
    jm, port = llamas
    ids = _prompts(3)
    ref = jgen.generate(jm, paddle.to_tensor(ids), max_new_tokens=new,
                        use_cache=use_cache).numpy()
    out = tgen.generate(port, ids, max_new_tokens=new, use_cache=use_cache)
    assert out.dtype == torch.int64 and out.shape == (2, 7 + new)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        port.generate(torch.from_numpy(ids), max_new_tokens=new,
                      use_cache=use_cache).numpy(), ref)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_generate_with_eos_matches(llamas, use_cache):
    """eos set to a token row 0 emits at its third new position: the row
    keeps emitting eos; with eos the first row's first new token, the
    JAX package's contract is the same (the other row runs on)."""
    jm, port = llamas
    ids = _prompts(4)
    free = tgen.generate(port, ids, max_new_tokens=5).numpy()
    for eos in (int(free[0, 7 + 2]), int(free[0, 7])):
        ref = jgen.generate(jm, paddle.to_tensor(ids), max_new_tokens=5,
                            eos_token_id=eos, use_cache=use_cache).numpy()
        out = tgen.generate(port, ids, max_new_tokens=5, eos_token_id=eos,
                            use_cache=use_cache).numpy()
        np.testing.assert_array_equal(out, ref)
        row = out[0, 7:]
        hit = int(np.argmax(row == eos))
        assert (row[hit:] == eos).all()


def test_every_row_done_fills_with_eos_without_model_calls(llamas):
    """Once every row emitted eos the rest is eos and the model is not
    called again."""
    _, port = llamas
    ids = _prompts(5, b=1)
    first = int(tgen.generate(port, ids, max_new_tokens=1).numpy()[0, -1])
    calls = []
    hook = port.register_forward_hook(lambda *a: calls.append(1))
    try:
        out = tgen.generate(port, ids, max_new_tokens=6,
                            eos_token_id=first).numpy()
    finally:
        hook.remove()
    assert (out[0, 7:] == first).all()
    assert len(calls) == 2  # the prefill and the step that found it done


def test_no_cache_generate_on_gpt_matches():
    """The port's GPT has no ``init_cache``: ``_generate_no_cache``
    against the JAX package's ``generate`` on the JAX GPT."""
    cfg = jgpt.GPTConfig.tiny()
    paddle.seed(0)
    jm = jgpt.GPT(cfg)
    jm.eval()
    port = tgpt.GPT(_port_cfg(tgpt.GPTConfig, cfg), device="cpu")
    port.load_state_dict(gpt_params_from_numpy(_named(jm), cfg))
    port.eval()
    assert not hasattr(port, "init_cache")
    ids = _prompts(6, s=5)
    for eos in (None, 7):
        ref = jgen.generate(jm, paddle.to_tensor(ids), max_new_tokens=3,
                            eos_token_id=eos).numpy()
        out = tgen.generate(port, ids, max_new_tokens=3,
                            eos_token_id=eos).numpy()
        np.testing.assert_array_equal(out, ref)


def test_sampled_generate_shape_and_eos_contract(llamas):
    _, port = llamas
    ids = _prompts(7, b=3)
    g = torch.Generator().manual_seed(0)
    out = tgen.generate(port, ids, max_new_tokens=10, temperature=0.8,
                        top_k=20, top_p=0.9, generator=g)
    assert out.shape == (3, 17) and out.dtype == torch.int64
    assert torch.equal(out[:, :7], torch.from_numpy(ids))
    assert ((out >= 0) & (out < 256)).all()
    g = torch.Generator().manual_seed(0)
    again = tgen.generate(port, ids, max_new_tokens=10, temperature=0.8,
                          top_k=20, top_p=0.9, generator=g)
    assert torch.equal(out, again)  # one generator, one draw
    eos = int(out[0, 7])
    g = torch.Generator().manual_seed(0)
    with_eos = tgen.generate(port, ids, max_new_tokens=10, temperature=0.8,
                             top_k=20, top_p=0.9, eos_token_id=eos,
                             generator=g)
    assert with_eos.shape == (3, 17)
    for row in with_eos[:, 7:]:
        hits = (row == eos).nonzero()
        if len(hits):
            assert (row[int(hits[0]):] == eos).all()
