"""PyTorch port: the int8 serving tier against the JAX package on the CPU.

- ``sized_num_blocks`` equals the JAX package's, so both engines preempt
  at the same step.
- Engines: ``LlamaConfig.tiny()`` served with ``kv_cache_dtype="int8"`` by
  the JAX engine (float32, CPU default routes) and by the port's
  (``device="cpu"``, float32): identical greedy tokens on the per-page
  route, the split route and with a pool small enough to preempt; and with
  int8 weights too (W8 + KV8), the model converted by each package's own
  ``QAT``, and again with JAX's converted buffers loaded through
  ``convert.llama_int8_params_from_numpy``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import quantization as JQ
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu_torch import ContinuousBatchingEngine, Llama, LlamaConfig
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.convert import (llama_int8_params_from_numpy,
                                      llama_params_from_numpy)
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.kernels.paged_attention import decode_kernel_takes
from paddle_tpu_torch.inference.paged import (ROUTE_COUNTS, PagedKVCache,
                                              decode_route,
                                              paged_decode_write_q,
                                              sized_num_blocks)

from test_torch_serving import _drive


def _qat(pkg):
    return pkg.QAT(pkg.QuantConfig(
        activation=None, weight=pkg.FakeQuanterWithAbsMaxObserver))


@pytest.mark.parametrize("max_batch,mbps,head_dim,dtype", [
    (8, 128, 128, "bfloat16"),   # Llama-3-8B, engine A's table
    (8, 15, 128, "bfloat16"),    # engine B's table
    (3, 8, 16, "float32"),       # the tiny engines below
    (3, 16, 16, "float32"),
])
def test_sized_num_blocks_matches_jax(max_batch, mbps, head_dim, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for kv in (None, "int8"):
        assert sized_num_blocks(None, max_batch, mbps, kv, head_dim, tdt) == \
            jpaged.sized_num_blocks(None, max_batch, mbps, kv, head_dim, jdt)
    assert sized_num_blocks(12, max_batch, mbps, "int8", head_dim, tdt) == 12


def test_int8_cache_pools_and_inactive_write():
    cache = PagedKVCache(2, 2, 8, num_blocks=5, block_size=4,
                         max_blocks_per_seq=2, max_batch=2,
                         dtype=torch.float32, kv_dtype="int8", device="cpu")
    assert cache.quantized and cache.k_pools[0].dtype == torch.int8
    assert cache.k_scales[1].shape == (5, 4, 2)
    assert cache.k_scales[1].dtype == torch.float32
    kp, vp = cache.k_pools[0], cache.v_pools[0]
    ksc, vsc = cache.k_scales[0], cache.v_scales[0]
    kp[0, 0] = 5
    ksc[0, 0] = 0.5
    rng = np.random.default_rng(0)
    k_new = torch.from_numpy(rng.standard_normal((2, 2, 8)).astype(
        np.float32))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    paged_decode_write_q(kp, vp, ksc, vsc, tables, torch.tensor([5, 1]),
                         k_new, -k_new, torch.tensor([True, False]))
    q, s = TQ.quantize_rows(k_new[0])
    assert torch.equal(kp[2, 1], q) and torch.equal(ksc[2, 1], s)
    assert torch.equal(vp[2, 1], -q)
    # the inactive slot wrote null block 0, row 0 back as it was
    assert torch.all(kp[0, 0] == 5) and torch.all(ksc[0, 0] == 0.5)
    assert not kp[4].any() and not ksc[4].any()


def test_kv_cache_dtype_flag_is_read_at_construction():
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    set_flags({"FLAGS_kv_cache_dtype": "int8"})
    try:
        eng = ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=32,
                                       dtype=torch.float32)
        explicit = ContinuousBatchingEngine(tm, max_batch=2, max_seq_len=32,
                                            dtype=torch.float32,
                                            kv_cache_dtype="none")
    finally:
        set_flags({"FLAGS_kv_cache_dtype": ""})
    assert eng.cache.quantized and eng.cache.k_pools[0].dtype == torch.int8
    assert not explicit.cache.quantized
    assert explicit.cache.k_pools[0].dtype == torch.float32


@pytest.fixture(scope="module")
def jax_models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    jw8 = _qat(JQ).convert(_qat(JQ).quantize(jm))
    return jm, jw8


def _port(jm):
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return tm


def _card_routes(eng, cfg, dtype):
    """(the decode route this engine's own query dtype and pools take on
    the card, the route bf16 tensors of its table width would take):
    ``decode_kernel_takes`` on a query of ``dtype`` over the engine's
    layer-0 pools decides between the tensor-core kernels and ``simt``."""
    c = eng.cache
    q = torch.empty(1, cfg.num_heads, c.k_pools[0].shape[-1], dtype=dtype)
    takes = decode_kernel_takes(q, c.k_pools[0], c.v_pools[0],
                                c.k_scales[0] if c.quantized else None)
    pages = c.block_tables.shape[1]
    return (decode_route("auto", "cuda", takes, pages),
            decode_route("auto", "cuda", True, pages))


def _serve(jm, tm, bf16_route, **kw):
    kw = dict(max_batch=3, temperature=0.0, kv_cache_dtype="int8", **kw)
    ref = _drive(jpaged.ContinuousBatchingEngine(jm, dtype=jnp.float32,
                                                 **kw))
    before = dict(ROUTE_COUNTS)
    eng = ContinuousBatchingEngine(tm, dtype=torch.float32, **kw)
    assert eng.cache.quantized
    out = _drive(eng)
    assert out == ref
    moved = {k for k in ROUTE_COUNTS if ROUTE_COUNTS[k] != before[k]}
    assert moved == {"plain"}  # one count a CPU call
    # on the card this float32 engine's int8 pools take the CUDA cores'
    # kernel; a bf16 one of the same table width the tensor-core kernel
    # named
    assert _card_routes(eng, tm.config, torch.float32) == ("simt",
                                                           bf16_route)
    assert not eng.running and not eng.waiting
    return eng


@pytest.mark.parametrize("block_size,max_seq_len,num_blocks,bf16_route", [
    (8, 64, None, "kernel"),   # 8 pages: per-page route (B5 for bf16)
    (4, 64, None, "split"),    # 16 pages: split route (B6q for bf16)
    (4, 64, 12, "split"),      # 11 usable blocks: forces preemption
])
def test_int8_kv_engine_tokens_identical(jax_models, block_size,
                                         max_seq_len, num_blocks,
                                         bf16_route):
    eng = _serve(jax_models[0], _port(jax_models[0]), bf16_route,
                 block_size=block_size, max_seq_len=max_seq_len,
                 num_blocks=num_blocks)
    if num_blocks is not None:
        assert eng.preemptions > 0


@pytest.mark.parametrize("load", ["port_qat", "converted_buffers"])
def test_w8_kv8_engine_tokens_identical(jax_models, load):
    """int8 weights and an int8 cache: the port's model converted by its
    own QAT, or carrying the JAX package's converted buffers."""
    jm, jw8 = jax_models
    tm = _qat(TQ).convert(_qat(TQ).quantize(_port(jm), inplace=True),
                          inplace=True)
    if load == "converted_buffers":
        named = {n: np.asarray(t._data) for n, t in
                 [*jw8.named_parameters(), *jw8.named_buffers()]}
        state = llama_int8_params_from_numpy(named, JaxConfig.tiny())
        tm.load_state_dict(state)
        for name, t in state.items():
            assert torch.equal(tm.state_dict()[name], t), name
    assert isinstance(tm.lm_head, TQ.ConvertedInt8Linear)
    _serve(jw8, tm, "kernel", block_size=8, max_seq_len=64)
