"""PyTorch port: self-speculative decode against the JAX package on the
CPU (``serving/spec.py``, ``PagedKVCache.prepare_append_range`` /
``truncate_blocks``, ``paged_spec_write[_q]``,
``paged_spec_attention_dense``, ``Llama.paged_spec_step`` and
``Scheduler._decode_spec``).

- ``propose_draft`` returns the reference's drafts exactly, on the
  reference's own cases and on a seeded sweep of contexts, budgets and
  n-gram lengths.
- One scripted sequence of ``prepare_append_range`` / ``truncate_blocks``
  on both caches (with a shared block copied on write and a capacity
  failure part-way through a range) leaves equal block tables, refcounts,
  free lists and ``_cached_free`` order after every step, equal pools and
  equal ``serving.prefix.*`` deltas.
- ``paged_spec_write[_q]``: bit-equal pools, bf16 and int8 with scales.
- ``paged_spec_attention_dense``: within atol 1e-5 in float32, with
  inactive slots and padded draft rows.
- ``Llama.paged_spec_step`` (``LlamaConfig.tiny()``, float32, the JAX
  model's parameters converted): equal tokens, float32 and int8 pools.
- ``ServingEngine(spec=True)`` end to end, mirroring the reference's
  ``tests/framework/test_spec_decode.py``: greedy tokens equal
  ``spec=False``'s and the JAX engine's on ``repetitive_prompts()`` and
  random prompts; the same ``serving.*`` counter deltas (``serving.spec.*``
  among them) as the JAX engine under preemption, with prefix hits, int8
  KV, 4-row blocks and eos inside an accepted run; rejected rows' blocks
  roll back after every step (and some do); the cost report bills the
  drafts; ``warmup()`` runs the verify program.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import paged as jpaged
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import spec as jspec
from paddle_tpu_torch import Llama, LlamaConfig, ServingEngine
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.inference import paged as tpaged
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.serving import Scheduler, RequestStatus
from paddle_tpu_torch.serving import bucket_lengths
from paddle_tpu_torch.serving import spec as tspec

BS = 8  # the block size of the reference's spec-decode engines


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return jm, tm


# -- the proposer ------------------------------------------------------------

def test_repetitive_corpus_is_the_reference_one():
    assert tspec.REPETITIVE_CORPUS == jspec.REPETITIVE_CORPUS
    for t, j in zip(tspec.repetitive_prompts(), jspec.repetitive_prompts()):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("ctx,k,want", [
    ([1, 2, 3, 1, 2, 3, 1, 2], 3, [3, 1, 2]),
    ([1, 2, 3, 1, 2, 3, 1, 2], 5, [3, 1, 2]),
    ([1, 2, 3, 1, 2, 3, 1, 2], 1, [3]),
    ([7, 5, 7], 4, [5, 7]),
    ([9, 1, 9, 2, 9], 1, [2]),
    ([1, 2, 3, 4, 5], 4, []),
    ([5], 4, []),
    ([1, 2, 1], 0, [])])
def test_propose_draft_reference_cases(ctx, k, want):
    assert tspec.propose_draft(ctx, k).tolist() == want
    assert jspec.propose_draft(ctx, k).tolist() == want


@pytest.mark.parametrize("seed", range(6))
def test_propose_draft_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n = int(rng.integers(0, 40))
        vocab = int(rng.integers(2, 12))
        ctx = rng.integers(0, vocab, (n,))
        if rng.random() < 0.3:  # a repeated phrase, as greedy text has
            phrase = rng.integers(0, 50, (int(rng.integers(1, 6)),))
            ctx = np.concatenate([ctx, np.tile(phrase, 3)])
        for k in (0, 1, 3, 4, 7):
            for ngram in (1, 2, 3, 5):
                got = tspec.propose_draft(ctx, k, ngram)
                ref = jspec.propose_draft(ctx, k, ngram)
                assert got.dtype == np.int64
                np.testing.assert_array_equal(got, ref)


# -- the rollback helpers ----------------------------------------------------

def _caches(kv_dtype, num_blocks=10):
    geo = dict(num_blocks=num_blocks, block_size=4, max_blocks_per_seq=6,
               max_batch=4, kv_dtype=kv_dtype)
    jc = jpaged.PagedKVCache(2, 2, 4, dtype=jnp.float32, **geo)
    tc = tpaged.PagedKVCache(2, 2, 4, dtype=torch.float32, device="cpu",
                             **geo)
    rng = np.random.default_rng(6)
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
                slots=[list(b) for b in c._slot_blocks],
                full=dict(c._prefix_index), part=dict(c._partial_index),
                occ=c.occupancy())


def _prefix_counts(metrics):
    snap = metrics.snapshot("serving.prefix.")
    return {n: snap.get(n, 0) for n in ("serving.prefix.cow_copies",
                                        "serving.prefix.evictions",
                                        "serving.prefix.hit_blocks")}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_append_range_and_truncate_state_equal(kv_dtype):
    jc, tc = _caches(kv_dtype)
    rng = np.random.default_rng(12)
    p1 = rng.integers(0, 255, (10,))            # 2 full chunks + 2
    p2 = rng.integers(0, 255, (5,))
    before = (_prefix_counts(jmetrics), _prefix_counts(tmetrics))
    slots = {}
    results = []

    def both(fn):
        rj, rt = fn(jc), fn(tc)
        rj = rj if rj is None or isinstance(rj, (int, np.integer)) \
            else (bool(rj), getattr(rj, "reason", None))
        rt = rt if rt is None or isinstance(rt, (int, np.integer)) \
            else (bool(rt), getattr(rt, "reason", None))
        assert rj == rt
        assert _host_state(jc) == _host_state(tc)
        results.append(rt)
        return rt

    def admit(name, prompt):
        def go(c):
            plan = c.plan_prefix(prompt)
            slot = c.alloc_slot_cached(plan)
            c.seq_lens[slot] = len(prompt)
            c.commit_prefix(slot, plan)
            return slot
        slots[name] = both(go)

    admit("a", p1)                      # 3 blocks, registered
    admit("b", p1.copy())               # shares all three
    admit("d", p1.copy())               # a third sharer
    # b's draft range covers the shared partial block and one fresh
    # block: one copy-on-write, growth to 4 blocks
    both(lambda c: c.prepare_append_range(slots["b"], 15))
    both(lambda c: c.truncate_blocks(slots["b"], 3))   # reject the growth
    admit("c", p2)                      # 2 blocks
    both(lambda c: c.prepare_append_range(slots["c"], 20))  # takes the
    both(lambda c: c.truncate_blocks(slots["c"], 2))        # last 3 free
    # a's range grows by 3 blocks (the pool's last), then needs a copy
    # of its tail block, still shared with d: the pool runs dry part-way
    # and a's fresh growth rolls back
    both(lambda c: c.prepare_append_range(slots["a"], 24))
    both(lambda c: c.prepare_append_range(slots["a"], 12))  # copy only
    both(lambda c: c.truncate_blocks(slots["a"], 1))  # shared + private
    both(lambda c: c.free_slot(slots["a"]))          # registered: parked
    both(lambda c: c.free_slot(slots["b"]))
    for name in ("k_pools", "v_pools") + (("k_scales", "v_scales")
                                          if tc.quantized else ()):
        for pj, pt in zip(getattr(jc, name), getattr(tc, name)):
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    after = (_prefix_counts(jmetrics), _prefix_counts(tmetrics))
    dj = {n: after[0][n] - before[0][n] for n in before[0]}
    dt = {n: after[1][n] - before[1][n] for n in before[1]}
    assert dj == dt
    assert dt["serving.prefix.cow_copies"] >= 2
    failures = [r for r in results if isinstance(r, tuple) and not r[0]]
    assert failures == [(False, "blocks")]


def _spec_inputs(quantized, b=3, s=5, seed=4):
    rng = np.random.default_rng(seed)
    nb, bs, hk, d = 9, 4, 2, 8
    if quantized:
        pools = [rng.integers(-127, 128, (nb, bs, hk, d)).astype(np.int8)
                 for _ in range(2)]
        pools += [(0.01 + 0.03 * rng.random((nb, bs, hk))).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal((nb, bs, hk, d)).astype(np.float32)
                 for _ in range(2)]
    tables = np.array([[3, 5, 1, 0], [6, 2, 0, 0], [7, 8, 4, 0]], np.int32)
    lens = np.array([6, 3, 9], np.int32)
    n_inputs = np.array([5, 2, 3], np.int32)
    active = np.array([True, True, False])
    k_new = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return pools, tables, lens, n_inputs, active, k_new, v_new


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_spec_write_bit_equal(quantized):
    pools, tables, lens, n_in, act, k_new, v_new = _spec_inputs(quantized)
    if not quantized:  # full-precision pools in bf16, as served
        pools = [p.astype(jnp.bfloat16) for p in pools]
    tp = [torch.from_numpy(np.asarray(p, np.float32)).to(torch.bfloat16)
          if not quantized else torch.from_numpy(p.copy()) for p in pools]
    jp = [jnp.asarray(p) for p in pools]
    dt = torch.bfloat16 if not quantized else torch.float32
    jdt = jnp.bfloat16 if not quantized else jnp.float32
    jargs = (jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(k_new, jdt),
             jnp.asarray(v_new, jdt), jnp.asarray(n_in), jnp.asarray(act))
    targs = (torch.from_numpy(tables), torch.from_numpy(lens),
             torch.from_numpy(k_new).to(dt), torch.from_numpy(v_new).to(dt),
             torch.from_numpy(n_in), torch.from_numpy(act))
    if quantized:
        out = jpaged.paged_spec_write(jp[0], jp[1], *jargs, k_scale=jp[2],
                                      v_scale=jp[3])
        tpaged.paged_spec_write_q(*tp, *targs)
    else:
        out = jpaged.paged_spec_write(*jp, *jargs)
        tpaged.paged_spec_write(*tp, *targs)
    for j, t in zip(out, tp):
        np.testing.assert_array_equal(t.float().numpy() if not quantized
                                      else t.numpy(),
                                      np.asarray(j).astype(np.float32)
                                      if not quantized else np.asarray(j))
    # the padded rows and the inactive slot left every other row alone
    for j, orig in zip(out, pools):
        for blk in (0, 4, 7, 8):
            np.testing.assert_array_equal(np.asarray(j)[blk],
                                          np.asarray(orig)[blk])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("seed", [4, 5])
def test_paged_spec_attention_equal(quantized, seed):
    pools, tables, lens, _, act, _, _ = _spec_inputs(quantized, seed=seed)
    rng = np.random.default_rng(seed + 30)
    q = rng.standard_normal((3, 5, 4, 8)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if quantized:
        kw_j = dict(k_scale=jnp.asarray(pools[2]),
                    v_scale=jnp.asarray(pools[3]))
        kw_t = dict(k_scale=torch.from_numpy(pools[2]),
                    v_scale=torch.from_numpy(pools[3]))
    ref = jpaged.paged_spec_attention_dense(
        jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(act), **kw_j)
    out = tpaged.paged_spec_attention_dense(
        torch.from_numpy(q), torch.from_numpy(pools[0]),
        torch.from_numpy(pools[1]), torch.from_numpy(tables),
        torch.from_numpy(lens), torch.from_numpy(act), **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    assert not out[2].any()  # the inactive slot gives zeros


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_spec_step_equal(models, kv_dtype):
    jm, tm = models
    cfg = LlamaConfig.tiny()
    geo = dict(num_blocks=24, block_size=4, max_blocks_per_seq=8,
               max_batch=4, kv_dtype=kv_dtype)
    jc = jpaged.PagedKVCache(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                             dtype=jnp.float32, **geo)
    tc = tpaged.PagedKVCache(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                             dtype=torch.float32, device="cpu", **geo)
    rng = np.random.default_rng(50)
    prompts = [rng.integers(0, 256, (n,)) for n in (7, 12, 5)]
    last = np.zeros((4,), np.int64)
    for model, c in ((jm, jc), (tm, tc)):
        for i, p in enumerate(prompts):
            slot = c.alloc_slot(len(p))
            last[slot] = int(model.paged_prefill(c, slot, p,
                                                 temperature=0.0))
    k = 4
    drafts = rng.integers(0, 256, (4, k)).astype(np.int64)
    n_inputs = np.array([5, 1, 3, 0], np.int64)
    active = np.array([True, True, True, False])
    for model, c in ((jm, jc), (tm, tc)):
        for slot in range(3):
            assert c.prepare_append_range(
                slot, int(c.seq_lens[slot]) + int(n_inputs[slot]))
    ref = np.asarray(jm.paged_spec_step(jc, last, drafts, n_inputs, active))
    out = tm.paged_spec_step(tc, last, drafts, n_inputs, active)
    assert out.shape == (4, 1 + k)
    for slot in range(3):
        n = int(n_inputs[slot])
        assert out[slot, :n].tolist() == ref[slot, :n].tolist()
    # seq_lens do not advance; the written rows agree
    assert tc.seq_lens.tolist() == jc.seq_lens.tolist()
    for name in ("k_pools", "v_pools"):
        for pj, pt in zip(getattr(jc, name), getattr(tc, name)):
            pj, pt = np.asarray(pj), pt.numpy()
            if tc.quantized:
                assert np.abs(pj.astype(np.int32)
                              - pt.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=1e-5)


# -- the scheduler -----------------------------------------------------------

def _counter_names():
    kinds = tmetrics.registry.kinds()
    return sorted(n for n, kd in kinds.items() if kd is tmetrics.Counter
                  and n.startswith("serving."))


def _snap(metrics, names):
    s = metrics.snapshot()
    return {n: s.get(n, 0) for n in names}


_COST_FIELDS = ("status", "tokens_prefilled", "tokens_decoded",
                "tokens_emitted", "covered_tokens", "spec_proposed",
                "spec_accepted", "preempts", "steps", "deadline_met")


def _engine(jax_side, models, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", BS)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("bucket_cap", 32)
    kw.setdefault("background", False)
    kw.setdefault("temperature", 0.0)
    if jax_side:
        return JaxServingEngine(models[0], dtype=jnp.float32, **kw)
    return ServingEngine(models[1], dtype=torch.float32, **kw)


def _serve(jax_side, models, prompts, max_new=10, **kw):
    """Serve ``prompts`` on one package's engine (default flags beside
    ``kw``): tokens, statuses, cost fields and ``serving.*`` deltas."""
    names = _counter_names()
    metrics = jmetrics if jax_side else tmetrics
    before = _snap(metrics, names)
    eng = _engine(jax_side, models, **kw)
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_until_idle()
    after = _snap(metrics, names)
    costs = [tuple(getattr(h.cost(), f) for f in _COST_FIELDS) for h in hs]
    out = ([h.tokens() for h in hs], [h.status for h in hs],
           [h.preempts for h in hs], costs,
           {n: after[n] - before[n] for n in names})
    eng.close()
    return out


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 250, size=s) for s in sizes]


def _shared_prefix(seed):
    rng = np.random.default_rng(seed)
    system = rng.integers(3, 250, size=24)
    return [np.concatenate([system, rng.integers(3, 250, size=4)])
            for _ in range(3)]


_REPETITIVE = tspec.repetitive_prompts()

# name: (prompts, new tokens, engine options); every case runs spec=True
SPEC_CASES = {
    "repetitive": (_REPETITIVE, 12, {}),
    "random": (_prompts(0, [9, 5, 14, 7]), 10, {}),
    "preemption": (_prompts(2, [9, 8]), 10,
                   dict(max_batch=2, num_blocks=6)),
    "prefix_hits": (_shared_prefix(3), 10, {}),
    "int8_kv": (_prompts(4, [9, 6, 12]), 10, dict(kv_cache_dtype="int8")),
    "long_run": (_REPETITIVE[:1], 24, {}),
    "small_blocks": (_REPETITIVE + _prompts(5, [9, 5, 12]), 16,
                     dict(block_size=4)),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_engine_matches_plain_and_reference(models, case):
    """Greedy tokens with spec=True equal spec=False's and the JAX
    engine's; every serving.* counter delta (the spec counters, prefix
    and preemption counters) and every cost-report count equal the JAX
    engine's."""
    prompts, new, kw = SPEC_CASES[case]
    ref = _serve(True, models, prompts, new, spec=True, **kw)
    got = _serve(False, models, prompts, new, spec=True, **kw)
    plain = _serve(False, models, prompts, new, spec=False, **kw)
    assert got[0] == plain[0] == ref[0]
    assert got[1:] == ref[1:]
    assert all(s == RequestStatus.DONE for s in got[1])
    deltas = got[4]
    assert deltas["serving.spec.proposed"] == \
        deltas["serving.spec.accepted"] + deltas["serving.spec.rejected"]
    if case in ("repetitive", "long_run"):
        assert deltas["serving.spec.proposed"] > 0
        assert deltas["serving.spec.accepted"] > 0
        assert deltas["serving.spec.steps"] > 0
    if case == "preemption":
        assert deltas["serving.preempt"] > 0
    if case == "prefix_hits":
        assert deltas["serving.prefix.hit_blocks"] > 0


def test_spec_counters_silent_when_off(models):
    before = tmetrics.snapshot("serving.spec.")
    _serve(False, models, _prompts(1, [8, 6]), spec=False)
    assert tmetrics.snapshot("serving.spec.") == before
    assert flag("FLAGS_serving_spec") is False


def test_spec_eos_mid_acceptance(models):
    """A draft run crossing eos stops at it: both packages, spec on and
    off, stop at the same token."""
    prompt = _REPETITIVE[0]
    base = _serve(False, models, [prompt], 12, spec=False)[0]
    eos = base[0][4]
    ref = _serve(True, models, [prompt], 12, spec=True, eos_token_id=eos)
    got = _serve(False, models, [prompt], 12, spec=True, eos_token_id=eos)
    plain = _serve(False, models, [prompt], 12, spec=False,
                   eos_token_id=eos)
    assert got[0] == plain[0] == ref[0]
    assert got[1:] == ref[1:]
    assert got[0][0][-1] == eos and len(got[0][0]) < 12


def test_spec_flag_routing(models):
    _, tm = models
    saved = {n: flag(n) for n in ("FLAGS_serving_spec",
                                  "FLAGS_serving_spec_tokens")}
    kw = dict(max_batch=2, block_size=BS, max_seq_len=64,
              dtype=torch.float32)
    try:
        set_flags({"FLAGS_serving_spec": True,
                   "FLAGS_serving_spec_tokens": 6})
        s = Scheduler(tm, **kw)
        assert s.spec and s.spec_tokens == 6
        assert not Scheduler(tm, spec=False, **kw).spec  # kwarg beats flag
        assert Scheduler(tm, spec_tokens=0, **kw).spec_tokens == 1
    finally:
        set_flags(saved)
    # greedy only: a sampling temperature disarms the tier, as in the
    # reference
    warm = Scheduler(tm, spec=True, temperature=0.7, **kw)
    jwarm = JaxScheduler(models[0], max_batch=2, block_size=BS,
                         max_seq_len=64, dtype=jnp.float32, spec=True,
                         temperature=0.7)
    assert warm.spec is jwarm.spec is False
    assert Scheduler(tm, **kw).spec_ngram == 3


def test_spec_rollback_block_accounting(models):
    """After every step each running slot holds exactly ceil(seq_len /
    block_size) blocks (rejected rows' growth went back), and the drained
    engine returns the whole pool. Blocks of 4 rows, so draft ranges cross
    block boundaries and rejections hand grown blocks back."""
    bs = 4
    eng = _engine(False, models, spec=True, block_size=bs)
    sched = eng.scheduler
    cache = sched.cache
    usable = cache.num_blocks - 1
    returned = []
    truncate = cache.truncate_blocks

    def counted(slot, keep):
        returned.append(max(len(cache._slot_blocks[slot]) - keep, 0))
        truncate(slot, keep)

    cache.truncate_blocks = counted
    for p in _REPETITIVE + _prompts(5, [9, 5, 12]):
        eng.submit(p, max_new_tokens=16)
    steps = 0
    while sched.has_work:
        s0 = tmetrics.snapshot()["serving.spec.steps"]
        eng.step()
        steps += tmetrics.snapshot()["serving.spec.steps"] - s0
        for slot in sched.running:
            want = max(math.ceil(int(cache.seq_lens[slot]) / bs), 1)
            assert len(cache._slot_blocks[slot]) == want
            assert (cache.block_tables[slot, want:] == 0).all()
    assert steps > 0
    assert sum(returned) > 0  # rejected rows' blocks did go back
    occ = cache.occupancy()
    assert occ["active"] == 0
    assert occ["free"] + occ["cached_free"] == usable
    eng.close()


def test_spec_cost_billing(models):
    """Drafts bill device time (weight 1 + proposed), emitted tokens
    count what streamed, and every step closes."""
    eng = _engine(False, models, spec=True)
    h = eng.submit(_REPETITIVE[0], max_new_tokens=24)
    eng.run_until_idle()
    cost = h.cost()
    assert cost.spec_proposed >= cost.spec_accepted > 0
    assert cost.tokens_emitted == len(h.tokens()) == 24
    acct = eng.accounting
    assert acct.tokens_processed > acct.tokens_emitted  # rejected drafts
    for e in acct.step_log:
        assert abs(e["attributed_us"] + e["compile_us"] + e["idle_us"]
                   - e["step_us"]) <= 1e-6 * max(e["step_us"], 1.0)
    eng.close()


def test_spec_warmup_runs_the_verify_program(models):
    """warmup() runs the verify sweep once beside the prefill buckets
    and the decode step, as the reference's does; live traffic then
    launches nothing new (no kernel is built on the CPU, and no program
    runs for the first time)."""
    _, tm = models
    calls = []
    orig = tm.paged_spec_step

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return orig(*a, **kw)

    tm.paged_spec_step = counted
    try:
        eng = _engine(False, models, spec=True, ready=False)
        jeng = _engine(True, models, spec=True, ready=False)
        n, jn = eng.warmup(), jeng.warmup()
        buckets = bucket_lengths(BS, 32, 64)
        assert n == jn == len(buckets) + 2  # + decode and verify
        assert calls == [(4, 4)]
        h = eng.submit(_REPETITIVE[0], max_new_tokens=8)
        eng.run_until_idle()
        assert h.status == RequestStatus.DONE
        assert h.cost().compile_us == 0.0
        assert len(calls) > 1  # live verify sweeps ran
        eng.close()
        jeng.close()
    finally:
        del tm.paged_spec_step
