"""PyTorch port: the serving slice against the JAX package.

``LlamaConfig.tiny()`` with the JAX model's parameters converted into the
port; the JAX ``ContinuousBatchingEngine`` (float32, CPU default routes)
and the port's (``device="cpu"``, float32) serve the same prompts with
staggered arrival and greedy decoding. Generated tokens must be identical
when the port takes the per-page route (< 16 pages), the split route
(>= 16 pages), and when a small pool forces preemption and re-prefill.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.paged import (
    ContinuousBatchingEngine as JaxEngine)
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu_torch import ContinuousBatchingEngine, Llama, LlamaConfig
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.inference.paged import (ROUTE_COUNTS, PagedKVCache,
                                              decode_route)
from paddle_tpu_torch.kernels.paged_attention import decode_kernel_takes


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return jm, tm


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (n,)).astype(np.int64)
            for n in (9, 5, 14, 11, 6)]


def _drive(engine):
    """Staggered arrival: two requests, three steps, one more, two steps,
    the last two, then drain."""
    prompts, news = _prompts(), (12, 9, 7, 10, 8)
    rids = [engine.add_request(prompts[i], max_new_tokens=news[i])
            for i in (0, 1)]
    for _ in range(3):
        engine.step()
    rids.append(engine.add_request(prompts[2], max_new_tokens=news[2]))
    for _ in range(2):
        engine.step()
    rids += [engine.add_request(prompts[i], max_new_tokens=news[i])
             for i in (3, 4)]
    out = engine.run_to_completion()
    return [list(map(int, out[r])) for r in rids]


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


@pytest.mark.parametrize("block_size,max_seq_len,num_blocks,bf16_route", [
    (8, 64, None, "kernel"),   # 8 pages: per-page route for bf16
    (4, 64, None, "split"),    # 16 pages: split route for bf16
    (4, 64, 12, "split"),      # 11 usable blocks: forces preemption
])
def test_engine_tokens_identical(models, block_size, max_seq_len,
                                 num_blocks, bf16_route):
    jm, tm = models
    kw = dict(max_batch=3, block_size=block_size, max_seq_len=max_seq_len,
              num_blocks=num_blocks, temperature=0.0)
    ref = _drive(JaxEngine(jm, dtype=jnp.float32, **kw))
    before = dict(ROUTE_COUNTS)
    eng = ContinuousBatchingEngine(tm, dtype=torch.float32, **kw)
    out = _drive(eng)
    assert out == ref
    moved = {k for k in ROUTE_COUNTS if ROUTE_COUNTS[k] != before[k]}
    assert moved == {"plain"}  # one count a CPU call
    # on the card this float32 engine takes the CUDA cores' kernel; a bf16
    # one of the same table width the tensor-core kernel named
    assert _card_routes(eng, tm.config, torch.float32) == ("simt",
                                                           bf16_route)
    if num_blocks is not None:
        assert eng.preemptions > 0
    assert not eng.running and not eng.waiting


def test_cache_host_logic():
    cache = PagedKVCache(1, 2, 8, num_blocks=5, block_size=4,
                         max_blocks_per_seq=3, max_batch=2,
                         dtype=torch.float32, device="cpu")
    s0 = cache.alloc_slot(5)                  # 2 blocks
    assert s0 == 0 and cache.block_tables[0].tolist() == [1, 2, 0]
    assert cache.ensure_capacity(0, 9) is True
    assert cache.block_tables[0].tolist() == [1, 2, 3]
    denied = cache.ensure_capacity(0, 13)
    assert not denied and denied.reason == "seq_limit"
    s1 = cache.alloc_slot(4)
    assert s1 == 1 and cache.num_free_blocks() == 0
    denied = cache.ensure_capacity(1, 5)
    assert not denied and denied.reason == "blocks"
    cache.free_slot(0)
    assert cache.num_free_blocks() == 3 and cache.seq_lens[0] == 0
    assert cache.block_tables[0].tolist() == [0, 0, 0]
    assert int(cache._refcount[1:4].sum()) == 0


def test_engine_validates_requests(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, max_batch=2, block_size=4,
                                   max_seq_len=16, dtype=torch.float32)
    with pytest.raises(ValueError, match="empty"):
        eng.add_request([], 2)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.add_request(np.arange(10), 8)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousBatchingEngine(tm, kv_cache_dtype="int4",
                                 dtype=torch.float32)


def test_dense_flag_is_read_at_construction(models):
    """FLAGS_paged_kernel=dense, read when the engine is built, forces the
    plain gather-then-attend version for every decode step."""
    from paddle_tpu_torch.core.flags import set_flags
    _, tm = models
    set_flags({"FLAGS_paged_kernel": "dense"})
    try:
        eng = ContinuousBatchingEngine(tm, max_batch=2, block_size=8,
                                       max_seq_len=64, dtype=torch.float32)
    finally:
        set_flags({"FLAGS_paged_kernel": "auto"})
    before = dict(ROUTE_COUNTS)
    eng.add_request(np.arange(5), 3)
    eng.run_to_completion()
    moved = {k for k in ROUTE_COUNTS if ROUTE_COUNTS[k] != before[k]}
    assert moved == {"dense"}
