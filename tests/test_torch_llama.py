"""PyTorch port: Llama modules vs the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages; parameters are
moved from the JAX model through ``paddle_tpu_torch.convert``. Float32,
atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.convert import (expected_shapes,
                                      llama_params_from_numpy)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.generation import sample_token
from paddle_tpu_torch.nn import functional as TF

ATOL = 1e-5


def _named(layer):
    return {n: np.asarray(p._data) for n, p in layer.named_parameters()}


def _load_converted(jax_layer, torch_layer):
    """Copy a JAX layer's parameters into the port's counterpart
    (Linear weights transposed, as ``convert`` does)."""
    state = {n: torch.from_numpy(np.array(
        a.T if n.endswith("_proj.weight") else a))
        for n, a in _named(jax_layer).items()}
    torch_layer.load_state_dict(state, strict=True)


@pytest.fixture(scope="module")
def cfg():
    return jllama.LlamaConfig.tiny()


def test_rope_interleaved_pairs_scalar_and_per_slot_offsets():
    """RoPE rotates (x[..., 0::2], x[..., 1::2]), not rotate_half; decode
    offsets are per slot."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    for off_j, off_t in ((3, 3),
                         (jnp.asarray([0, 7], jnp.int32),
                          torch.tensor([0, 7], dtype=torch.int32))):
        jq, jk = jllama.apply_rope(paddle.to_tensor(q), paddle.to_tensor(k),
                                   theta=500000.0, position_offset=off_j)
        tq, tk = tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                                   theta=500000.0, position_offset=off_t)
        np.testing.assert_allclose(tq.numpy(), jq.numpy(), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), jk.numpy(), atol=ATOL)
    # position 0 is the identity; a rotate_half rope would differ at s > 0
    tq0, _ = tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k))
    assert torch.allclose(tq0[:, 0], torch.from_numpy(q[:, 0]))


def test_rms_norm_and_swiglu():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    ref = JF.rms_norm(paddle.to_tensor(x), paddle.to_tensor(w), 1e-5)
    out = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    # bf16 input: float32 compute, cast back
    xb = torch.from_numpy(x).bfloat16()
    assert TF.rms_norm(xb, torch.from_numpy(w)).dtype == torch.bfloat16
    y = rng.standard_normal((3, 7, 64)).astype(np.float32)
    ref = JF.swiglu(paddle.to_tensor(x), paddle.to_tensor(y))
    out = TF.swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


def test_mlp_matches(cfg):
    jm = jllama.LlamaMLP(cfg)
    tm = tllama.LlamaMLP(tllama.LlamaConfig.tiny(), device="cpu",
                         dtype=torch.float32)
    _load_converted(jm, tm)
    x = np.random.default_rng(2).standard_normal((2, 6, 64)).astype(
        np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), atol=ATOL)


def test_block_matches_with_converted_params(cfg):
    jb = jllama.LlamaBlock(cfg)
    tb = tllama.LlamaBlock(tllama.LlamaConfig.tiny(), device="cpu",
                           dtype=torch.float32)
    _load_converted(jb, tb)
    x = np.random.default_rng(3).standard_normal((2, 11, 64)).astype(
        np.float32)
    sink_j, sink_t = [], []
    ref = jb(paddle.to_tensor(x), kv_sink=sink_j)
    out = tb(torch.from_numpy(x), kv_sink=sink_t)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=ATOL)
    for (jk, jv), (tk, tv) in zip(sink_j, sink_t):  # post-rope KV
        np.testing.assert_allclose(tk.numpy(), jk.numpy(), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), jv.numpy(), atol=ATOL)


@pytest.fixture(scope="module")
def jax_model(cfg):
    paddle.seed(0)
    m = jllama.Llama(cfg)
    m.eval()
    return m


def test_conversion_maps_every_name(cfg, jax_model):
    named = _named(jax_model)
    state = llama_params_from_numpy(named, cfg)
    assert set(state) == set(named)
    port = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    port_names = dict(port.named_parameters())
    assert set(state) == set(port_names)
    for n, t in state.items():
        assert tuple(t.shape) == tuple(port_names[n].shape) == \
            expected_shapes(cfg)[n]
        if n.endswith("_proj.weight") or n == "lm_head.weight":
            np.testing.assert_array_equal(t.numpy(), named[n].T)
        else:
            np.testing.assert_array_equal(t.numpy(), named[n])
    port.load_state_dict(state, strict=True)
    with pytest.raises(ValueError, match="missing"):
        llama_params_from_numpy(
            {n: a for n, a in named.items() if n != "norm.weight"}, cfg)
    with pytest.raises(ValueError, match="unexpected"):
        llama_params_from_numpy(dict(named, extra=np.zeros(1)), cfg)


def test_dense_forward_matches(cfg, jax_model):
    port = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    port.load_state_dict(llama_params_from_numpy(_named(jax_model), cfg))
    ids = np.random.default_rng(4).integers(0, 256, (2, 13)).astype(
        np.int64)
    ref = jax_model(paddle.to_tensor(ids)).numpy()
    out = port(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_sample_token_greedy_and_filtered():
    logits = torch.tensor([[0.1, 2.0, -1.0, 1.9], [3.0, 0.0, 0.0, 0.0]])
    assert sample_token(logits, temperature=0.0).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample_token(logits, temperature=1.0, top_k=2, generator=g)
        assert tok[0].item() in (1, 3) and tok[1].item() in (0, 1, 2, 3)
        # top-p keeps the token that crosses the threshold (as the JAX
        # package does): {1, 3} in row 0, {0} in row 1
        tok = sample_token(logits, temperature=1.0, top_p=0.5, generator=g)
        assert tok[0].item() in (1, 3) and tok[1].item() == 0


def test_sample_token_top_p_near_one_keeps_every_token():
    """At Llama-3's vocabulary (128256) with near-uniform logits the
    float32 cumulative sum never reaches top_p 0.9999999, so the cutoff
    index is V. The JAX package's ``take_along_axis`` reads it as NaN and
    keeps every token; the port clamps it to V - 1 (the smallest logit),
    which keeps every token too, where the gather used to raise."""
    V = 128256
    logits = np.random.default_rng(5).normal(0.0, 0.01, (2, V)).astype(
        np.float32)
    t = torch.from_numpy(logits)
    cum = torch.softmax(torch.sort(t, -1, descending=True).values,
                        -1).cumsum(-1)
    assert ((cum < 0.9999999).sum(-1) == V).any()  # the case at issue
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        tok = sample_token(t, temperature=1.0, top_p=0.9999999, generator=g)
        assert tok.shape == (2,) and bool(((tok >= 0) & (tok < V)).all())
    jtok = np.asarray(jgen.sample_token(jnp.asarray(logits), top_p=0.9999999,
                                        key=jax.random.PRNGKey(0)))
    assert jtok.shape == (2,) and ((jtok >= 0) & (jtok < V)).all()
