"""PyTorch port: the prefix cache of ``inference/paged.py`` and
``Llama.paged_prefill_extend`` against the JAX package on the CPU.

- ``chunk_digests`` and the partial-block keys are the same bytes.
- One scripted sequence of ``plan_prefix`` / ``alloc_slot_cached`` /
  ``commit_prefix`` / ``prepare_append`` / ``alloc_slot`` / ``free_slot``
  on both caches (full-precision and int8 pools filled with the same
  random rows) leaves equal block tables, refcounts, index contents, free
  lists and ``_cached_free`` order after every step, equal pools (the
  copy-on-writes) and equal ``serving.prefix.*`` counter deltas.
- ``paged_prefill_write_masked[_q]`` and ``paged_prefix_attention_dense``
  within atol/rtol 1e-5 on the same inputs.
- ``paged_prefill_extend`` (``LlamaConfig.tiny()``, float32, the JAX
  model's parameters converted): equal tokens, and pools within 1e-5
  (float32 pools) or rows within 1 and scales within 1e-5 (int8 pools),
  for a partial hit, a copied partial block and full coverage, with a
  bucketed tail.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu_torch import Llama, LlamaConfig
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.profiler import metrics as tmetrics

PREFIX_COUNTERS = ("serving.prefix.hit_blocks", "serving.prefix.miss_blocks",
                   "serving.prefix.cow_copies", "serving.prefix.evictions")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return jm, tm


def _counts(metrics):
    snap = metrics.snapshot("serving.prefix.")
    return {n: snap.get(n, 0) for n in PREFIX_COUNTERS}


def _delta(before, after):
    return {n: after[n] - before[n] for n in before}


@pytest.mark.parametrize("block_size", [1, 4, 16])
@pytest.mark.parametrize("n", [0, 3, 16, 37])
def test_chunk_digests_bytes_equal(block_size, n):
    rng = np.random.default_rng(n * 31 + block_size)
    ids = rng.integers(0, 1 << 20, (n,))
    for arr in (ids.astype(np.int64), ids.astype(np.int32),
                ids.astype(np.int64).tolist()):
        assert tpaged.chunk_digests(arr, block_size) == \
            jpaged.chunk_digests(arr, block_size)
    parent = tpaged.chunk_digests(ids, block_size)[-1:] or [b""]
    assert tpaged._partial_key(parent[0], ids[:3]) == \
        jpaged._partial_key(parent[0], ids[:3])


def _caches(kv_dtype, num_blocks=12):
    geo = dict(num_blocks=num_blocks, block_size=4, max_blocks_per_seq=6,
               max_batch=3, kv_dtype=kv_dtype)
    jc = jpaged.PagedKVCache(2, 2, 4, dtype=jnp.float32, **geo)
    tc = tpaged.PagedKVCache(2, 2, 4, dtype=torch.float32, device="cpu",
                             **geo)
    rng = np.random.default_rng(5)
    names = ["k_pools", "v_pools"] + (["k_scales", "v_scales"]
                                      if tc.quantized else [])
    for name in names:
        for i, pool in enumerate(getattr(tc, name)):
            if pool.dtype == torch.int8:
                vals = rng.integers(-127, 128, tuple(pool.shape))
            else:
                vals = rng.standard_normal(tuple(pool.shape))
            vals = vals.astype(str(pool.dtype).replace("torch.", ""))
            pool.copy_(torch.from_numpy(vals))
            getattr(jc, name)[i] = jnp.asarray(vals)
    return jc, tc


def _host_state(c):
    return dict(tables=c.block_tables.tolist(), lens=c.seq_lens.tolist(),
                ref=c._refcount.tolist(), free=list(c._free),
                cached=list(c._cached_free),
                slots=[list(b) for b in c._slot_blocks], live=list(c._live),
                full=dict(c._prefix_index), part=dict(c._partial_index),
                keys={b: list(k) for b, k in c._block_keys.items()},
                nfree=c.num_free_blocks(), ncached=c.num_cached_blocks(),
                nshared=c.num_shared_blocks())


def _pools(c):
    names = ["k_pools", "v_pools"] + (["k_scales", "v_scales"]
                                      if c.quantized else [])
    return [np.asarray(p) for n in names for p in getattr(c, n)]


def _result(r):
    if r is None or isinstance(r, (bool, int, np.integer)):
        return r
    return (bool(r), getattr(r, "reason", None))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cache_sequence_state_equal(kv_dtype):
    jc, tc = _caches(kv_dtype)
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, 255, (14,))            # 3 full chunks + 2
    p3 = np.concatenate([p1, rng.integers(0, 255, (3,))])  # extends p1
    p4 = rng.integers(0, 255, (9,))             # unrelated
    before = (_counts(jmetrics), _counts(tmetrics))
    slots = {}

    def both(fn):
        rj, rt = fn(jc), fn(tc)
        assert _result(rj) == _result(rt)
        assert _host_state(jc) == _host_state(tc)
        return rt

    def admit(name, prompt):
        def go(c):
            plan = c.plan_prefix(prompt)
            slot = c.alloc_slot_cached(plan)
            if slot is not None:
                c.seq_lens[slot] = len(prompt)
                c.commit_prefix(slot, plan)
            return slot
        slots[name] = both(go)

    admit("a", p1)                          # cold: 4 fresh blocks
    admit("b", p1)                          # full coverage, shared tail
    both(lambda c: c.prepare_append(slots["a"], 15))  # COW of the tail
    both(lambda c: c.prepare_append(slots["b"], 15))  # sole sharer: in place
    admit("c", p3)                          # partial match: copied
    both(lambda c: c.free_slot(slots["a"]))
    both(lambda c: c.free_slot(slots["b"]))  # registered blocks park
    admit("d", p4)
    both(lambda c: c.prepare_append(slots["d"], 13))  # growth
    both(lambda c: c.free_slot(slots["c"]))
    both(lambda c: c.free_slot(slots["d"]))
    big = both(lambda c: c.alloc_slot(24))  # evicts LRU cached blocks
    admit("e", p1)                          # what survived eviction
    both(lambda c: c.alloc_slot(24))        # no slot left: None
    both(lambda c: c.free_slot(big))
    both(lambda c: c.free_slot(slots["e"]))
    for pj, pt in zip(_pools(jc), _pools(tc)):
        np.testing.assert_array_equal(pj, pt)
    after = (_counts(jmetrics), _counts(tmetrics))
    dj, dt = _delta(*[x[0] for x in (before, after)]), \
        _delta(*[x[1] for x in (before, after)])
    assert dj == dt
    assert dt["serving.prefix.cow_copies"] == 2
    assert dt["serving.prefix.evictions"] > 0
    assert tc.occupancy() == jc.occupancy()
    assert tc.reclaimable_blocks(0) == jc.reclaimable_blocks(0)


def _write_inputs(quantized, s=8, seed=3):
    rng = np.random.default_rng(seed)
    nb, bs, hk, d = 7, 4, 2, 8
    if quantized:
        pools = [rng.integers(-127, 128, (nb, bs, hk, d)).astype(np.int8)
                 for _ in range(2)]
        # scales as quantize_rows makes them from N(0, 1) rows: ~3 / 127
        pools += [(0.01 + 0.03 * rng.random((nb, bs, hk))).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal((nb, bs, hk, d)).astype(np.float32)
                 for _ in range(2)]
    row = np.array([3, 5, 1, 6, 0, 0], np.int32)
    k_new = rng.standard_normal((s, hk, d)).astype(np.float32)
    v_new = rng.standard_normal((s, hk, d)).astype(np.float32)
    return pools, row, k_new, v_new


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("start,write_start,total", [
    (0, 0, 5), (6, 9, 13), (11, 11, 12), (12, 14, 14)])
def test_paged_prefill_write_masked_equal(quantized, start, write_start,
                                          total):
    pools, row, k_new, v_new = _write_inputs(quantized)
    tp = [torch.from_numpy(p.copy()) for p in pools]
    jp = [jnp.asarray(p) for p in pools]
    args = (k_new, v_new, start, write_start, total)
    if quantized:
        out = jpaged.paged_prefill_write_masked_q(
            *jp, jnp.asarray(row), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.int32(start), jnp.int32(write_start), jnp.int32(total))
        tpaged.paged_prefill_write_masked_q(
            *tp, torch.from_numpy(row), torch.from_numpy(k_new),
            torch.from_numpy(v_new), start, write_start, total)
    else:
        out = jpaged.paged_prefill_write_masked(
            *jp, jnp.asarray(row), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.int32(start), jnp.int32(write_start), jnp.int32(total))
        tpaged.paged_prefill_write_masked(
            *tp, torch.from_numpy(row), *map(torch.from_numpy, args[:2]),
            *args[2:])
    for j, t, orig in zip(out, tp, pools):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)
    # null block 0 and unlisted blocks keep their rows
    for t, orig in zip(tp, pools):
        for b in (0, 2, 4):
            np.testing.assert_array_equal(t.numpy()[b], orig[b])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("q_start,total", [(0, 6), (5, 9), (13, 16),
                                           (20, 22)])
def test_paged_prefix_attention_equal(quantized, q_start, total):
    pools, row, _, _ = _write_inputs(quantized)
    rng = np.random.default_rng(q_start + 17)
    q = rng.standard_normal((4, 4, 8)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if quantized:
        kw_j = dict(k_scale=jnp.asarray(pools[2]),
                    v_scale=jnp.asarray(pools[3]))
        kw_t = dict(k_scale=torch.from_numpy(pools[2]),
                    v_scale=torch.from_numpy(pools[3]))
    ref = jpaged.paged_prefix_attention_dense(
        jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(row), jnp.int32(q_start), jnp.int32(total), **kw_j)
    out = tpaged.paged_prefix_attention_dense(
        torch.from_numpy(q), torch.from_numpy(pools[0]),
        torch.from_numpy(pools[1]), torch.from_numpy(row), q_start, total,
        **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def _extend_caches(kv_dtype):
    geo = dict(num_blocks=20, block_size=4, max_blocks_per_seq=12,
               max_batch=4, kv_dtype=kv_dtype)
    cfg = LlamaConfig.tiny()
    return (jpaged.PagedKVCache(cfg.num_layers, cfg.num_kv_heads,
                                cfg.head_dim, dtype=jnp.float32, **geo),
            tpaged.PagedKVCache(cfg.num_layers, cfg.num_kv_heads,
                                cfg.head_dim, dtype=torch.float32,
                                device="cpu", **geo))


def _assert_pools_close(jc, tc):
    for name in ("k_pools", "v_pools"):
        for pj, pt in zip(getattr(jc, name), getattr(tc, name)):
            pj, pt = np.asarray(pj), pt.numpy()
            if tc.quantized:
                assert np.abs(pj.astype(np.int32)
                              - pt.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=1e-5)
    if tc.quantized:
        for name in ("k_scales", "v_scales"):
            for pj, pt in zip(getattr(jc, name), getattr(tc, name)):
                np.testing.assert_allclose(pt.numpy(), np.asarray(pj),
                                           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_prefill_extend_equal(models, kv_dtype):
    jm, tm = models
    jc, tc = _extend_caches(kv_dtype)
    rng = np.random.default_rng(40)
    base = rng.integers(0, 256, (14,)).astype(np.int64)
    prompts = [base,                                        # cold
               np.concatenate([base[:9], rng.integers(0, 256, (7,))]),
               np.concatenate([base, rng.integers(0, 256, (5,))]),
               base.copy()]                                 # full coverage
    toks = []
    for i, prompt in enumerate(prompts):
        out = []
        for model, c in ((jm, jc), (tm, tc)):
            plan = c.plan_prefix(prompt)
            slot = c.alloc_slot_cached(plan)
            if plan.covered_tokens:
                tok = model.paged_prefill_extend(
                    c, slot, prompt, plan.tail_start, plan.write_start,
                    temperature=0.0, pad_to=16)
            else:
                tok = model.paged_prefill(c, slot, prompt, temperature=0.0,
                                          pad_to=16)
            c.commit_prefix(slot, plan)
            out.append((int(tok), plan.covered_tokens, slot))
        assert out[0] == out[1], (i, out)
        toks.append(out[1])
        assert tc.seq_lens.tolist() == jc.seq_lens.tolist()
        _assert_pools_close(jc, tc)
    # cold, a 2-chunk hit, a copied partial block, full coverage
    assert [t[1] for t in toks] == [0, 8, 14, 14]
