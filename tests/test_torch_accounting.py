"""PyTorch port: per-request cost accounting (``profiler/accounting.py``)
against the JAX package on the CPU.

- With default flags both packages' engines are armed
  (``FLAGS_serving_accounting`` True): ``accounting.*`` count deltas and
  every request's ``CostReport`` count fields are equal
  (``LlamaConfig.tiny()``, float32, the JAX model's parameters
  converted).
- On shared traffic, preemption with re-prefill, prefix hits, int8 KV,
  speculative decode, a deadline and cancellation, the ``CostReport``
  token, speculation, preemption, step and status fields equal the JAX
  engine's, and every step closes: attributed + build + idle equals the
  measured step time; per-request attribution sums to the engine's.
  Time fields are not compared: the JAX package's include XLA compiles.
- ``flops_per_token`` and ``matmul_params`` equal the reference's for
  ``tiny()`` and ``llama3_8b()``; ``detect_peak_flops()`` is None on the
  CPU and honours ``ACCOUNTING_PEAK_FLOPS``; the MFU gauge runs on the
  processed-token axis.
- ``FLAGS_serving_accounting=0`` holds the null accountant: no
  ``accounting.*`` movement and ``handle.cost()`` None, as in the
  reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import accounting as jaccounting
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import Llama, LlamaConfig, ServingEngine
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.profiler import accounting as taccounting
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.serving import RequestStatus
from paddle_tpu_torch.serving.spec import repetitive_prompts

# accounting.* counters that count tokens and steps (the rest are times)
COUNT_COUNTERS = ("accounting.steps", "accounting.tokens_emitted",
                  "accounting.tokens_processed",
                  "accounting.goodput_tokens",
                  "accounting.deadline_missed_tokens")
COST_FIELDS = ("rid", "status", "tokens_prefilled", "tokens_decoded",
               "tokens_emitted", "covered_tokens", "spec_proposed",
               "spec_accepted", "preempts", "steps", "deadline_met",
               "transfer_bytes")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return jm, tm


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (s,)).astype(np.int64) for s in sizes]


def _engine(jax_side, models, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("background", False)
    kw.setdefault("temperature", 0.0)
    if jax_side:
        return JaxServingEngine(models[0], dtype=jnp.float32, **kw)
    return ServingEngine(models[1], dtype=torch.float32, **kw)


def _counts(metrics):
    snap = metrics.snapshot("accounting.")
    return {n: snap.get(n, 0) for n in COUNT_COUNTERS}


def _assert_closure(acct, min_steps=1):
    """Every logged step: attributed + build + idle == measured."""
    assert len(acct.step_log) >= min_steps
    for rec in acct.step_log:
        parts = rec["attributed_us"] + rec["compile_us"] + rec["idle_us"]
        assert abs(parts - rec["step_us"]) <= \
            max(1e-6 * rec["step_us"], 1e-6), rec


def _bill(jax_side, models, scenario):
    """Run ``scenario(engine, submit)`` on one package; every handle's
    cost fields, the accounting count deltas and the engine."""
    before = _counts(jmetrics if jax_side else tmetrics)
    handles = []
    eng = None

    def make(**kw):
        nonlocal eng
        eng = _engine(jax_side, models, **kw)
        return eng

    def submit(prompt, n, **kw):
        h = eng.submit(prompt, max_new_tokens=n, **kw)
        handles.append(h)
        return h

    scenario(make, submit)
    after = _counts(jmetrics if jax_side else tmetrics)
    costs = [tuple(getattr(h.cost(), f) for f in COST_FIELDS)
             for h in handles]
    eng.close()
    return costs, {n: after[n] - before[n] for n in before}, eng, handles


def scenario_default(make, submit):
    eng = make()
    for p in _prompts(0, [5, 9, 12]):
        submit(p, 5)
    eng.run_until_idle()


def scenario_preemption(make, submit):
    eng = make(block_size=4, max_seq_len=32, num_blocks=8,
               prefix_cache=False)
    for p in _prompts(1, [8, 8]):
        submit(p, 12)
    eng.run_until_idle()


def scenario_prefix_hits(make, submit):
    eng = make(bucket_cap=32)
    rng = np.random.default_rng(2)
    system = rng.integers(0, 255, (24,)).astype(np.int64)
    for _ in range(3):
        submit(np.concatenate([system, rng.integers(0, 255, (3,))]), 4)
        eng.run_until_idle()


def scenario_int8_spec(make, submit):
    eng = make(max_batch=4, bucket_cap=32, kv_cache_dtype="int8",
               spec=True)
    for p in repetitive_prompts():
        submit(p, 12)
    eng.run_until_idle()


def scenario_deadline_cancel(make, submit):
    eng = make(max_batch=1)
    p1, p2, p3 = _prompts(3, [9, 7, 6])
    submit(p1, 8, deadline_s=0.0)     # expires in the queue
    submit(p2, 4)
    h = submit(p3, 6)
    eng.step()
    h.cancel()
    eng.run_until_idle()


SCENARIOS = [scenario_default, scenario_preemption, scenario_prefix_hits,
             scenario_int8_spec, scenario_deadline_cancel]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[9:] for s in SCENARIOS])
def test_cost_reports_match_reference(models, scenario):
    jcosts, jdelta, jeng, _ = _bill(True, models, scenario)
    costs, delta, eng, handles = _bill(False, models, scenario)
    assert costs == jcosts
    assert delta == jdelta
    acct = eng.accounting
    _assert_closure(acct, min_steps=2)
    # per-request attribution sums to the engine's attributed + build
    total = sum(h.cost().attributed_us for h in handles)
    assert total == pytest.approx(acct.attributed_us + acct.compile_us,
                                  rel=1e-6)
    for h in handles:
        c = h.cost()
        assert c.attributed_us == pytest.approx(
            c.prefill_us + c.decode_us + c.compile_us + c.reprefill_us)
        assert c.compile_us == 0.0  # nothing builds on the CPU
        if c.status == RequestStatus.DONE:
            assert c.tokens_emitted == len(h.tokens())
            assert c.ttft_us > 0 and c.queue_us >= 0
    # the engine-level report agrees with the reference's count axes
    rep, jrep = acct.engine_report(), jeng.accounting.engine_report()
    for k in ("tokens", "tokens_processed", "goodput_tokens",
              "missed_tokens", "requests_finished"):
        assert rep[k] == jrep[k], k
    assert rep["mfu"] is None  # no peak on the CPU
    assert "goodput:" in acct.goodput_line()


def test_scenarios_exercise_their_axes(models):
    """The parity runs above are worth their cases: re-prefill bills to
    the preemption, hits bill extend-only, drafts bill their positions,
    an expired deadline misses."""
    costs = {s.__name__[9:]: _bill(False, models, s)
             for s in (scenario_preemption, scenario_prefix_hits,
                       scenario_int8_spec, scenario_deadline_cancel)}
    _, _, eng, hs = costs["preemption"]
    victim = max(hs, key=lambda h: h.preempts)
    assert victim.preempts >= 1 and victim.cost().reprefill_us > 0
    assert eng.accounting.reprefill_us > 0
    _, _, _, hs = costs["prefix_hits"]
    cold, warm = hs[0].cost(), hs[1].cost()
    assert cold.covered_tokens == 0 and warm.covered_tokens == 24
    assert warm.tokens_prefilled < cold.tokens_prefilled
    _, _, eng, hs = costs["int8_spec"]
    assert sum(h.cost().spec_proposed for h in hs) > 0
    assert eng.accounting.tokens_processed > eng.accounting.tokens_emitted
    _, delta, _, hs = costs["deadline_cancel"]
    assert [h.status for h in hs] == ["TIMEOUT", "DONE", "CANCELLED"]
    assert hs[0].cost().deadline_met is False
    assert hs[2].cost().deadline_met is None
    assert delta["accounting.goodput_tokens"] == 4


def test_default_flags_arm_accounting_like_the_reference(models):
    """The port's default engine bills as the reference's default engine
    does: FLAGS_serving_accounting is True in both, and with no
    ``accounting=`` argument both accountants are armed and move the same
    accounting.* counts and CostReport fields."""
    assert flag("FLAGS_serving_accounting") is True
    assert paddle.get_flags(["FLAGS_serving_accounting"])[
        "FLAGS_serving_accounting"] is True
    res = {}
    for jax_side in (True, False):
        before = _counts(jmetrics if jax_side else tmetrics)
        eng = (JaxServingEngine(models[0], dtype=jnp.float32,
                                background=False, max_batch=2,
                                block_size=8, max_seq_len=64)
               if jax_side else
               ServingEngine(models[1], dtype=torch.float32,
                             background=False, max_batch=2, block_size=8,
                             max_seq_len=64))
        assert eng.accounting.armed
        hs = [eng.submit(p, max_new_tokens=4) for p in _prompts(7, [6, 11])]
        eng.run_until_idle()
        after = _counts(jmetrics if jax_side else tmetrics)
        res[jax_side] = ([tuple(getattr(h.cost(), f) for f in COST_FIELDS)
                          for h in hs],
                         {n: after[n] - before[n] for n in before})
        eng.close()
    assert res[False] == res[True]
    assert res[False][1]["accounting.steps"] > 0


def test_flag_off_is_the_null_accountant(models):
    saved = flag("FLAGS_serving_accounting")
    set_flags({"FLAGS_serving_accounting": False})
    try:
        before = tmetrics.snapshot("accounting.")
        eng = _engine(False, models)
        assert eng.accounting is taccounting.NULL
        h = eng.submit(_prompts(8, [7])[0], max_new_tokens=3)
        eng.run_until_idle()
        assert h.status == RequestStatus.DONE and h.cost() is None
        assert eng.accounting.engine_report() is None
        assert "disarmed" in eng.accounting.goodput_line()
        assert tmetrics.snapshot("accounting.") == before
        eng.close()
    finally:
        set_flags({"FLAGS_serving_accounting": saved})
    # the ctor argument beats the flag
    eng = _engine(False, models, accounting=False)
    assert not eng.accounting.armed
    eng.close()


@pytest.mark.parametrize("which", ["tiny", "llama3_8b", "llama2_7b"])
def test_flops_per_token_matches_reference(which):
    tc, jc = getattr(LlamaConfig, which)(), getattr(JaxConfig, which)()
    assert taccounting.matmul_params(tc) == jaccounting.matmul_params(jc)
    assert taccounting.flops_per_token(tc) == jaccounting.flops_per_token(jc)
    assert taccounting.matmul_params(object()) is None


def test_detect_peak_flops_cpu_and_override(monkeypatch):
    monkeypatch.delenv("ACCOUNTING_PEAK_FLOPS", raising=False)
    assert taccounting.detect_peak_flops() is None
    assert taccounting.detect_peak_flops("cpu") is None
    monkeypatch.setenv("ACCOUNTING_PEAK_FLOPS", "1.5e14")
    assert taccounting.detect_peak_flops() == 1.5e14
    monkeypatch.setenv("ACCOUNTING_PEAK_FLOPS", "not a number")
    assert taccounting.detect_peak_flops() is None


def test_mfu_runs_on_processed_tokens():
    """The MFU estimate divides processed (computed) tokens, not emitted
    ones, by the measured time, as the reference's does."""
    cfg = LlamaConfig.tiny()
    accts = [mod.Accountant(config=c, peak_flops=1e12)
             for mod, c in ((taccounting, cfg),
                            (jaccounting, JaxConfig.tiny()))]

    class Req:
        def __init__(self, rid):
            self.rid, self.cost, self.preempts = rid, None, 0

    for acct in accts:
        r = Req(0)
        acct.attach(r)
        acct.step_begin()
        acct.note_prefill(r, 64, 0, 0.0, reprefill=False)
        acct.note_spec(r, emitted=2, proposed=4, accepted=1)
        acct.step_end(2000.0)
    rep, jrep = accts[0].engine_report(), accts[1].engine_report()
    assert rep["tokens_processed"] == jrep["tokens_processed"] == 69
    assert rep["tokens"] == jrep["tokens"] == 3
    assert rep["mfu"] == pytest.approx(jrep["mfu"], rel=1e-12)
    assert rep["mfu"] == pytest.approx(
        69 / 2e-3 * taccounting.flops_per_token(cfg) / 1e12)


def test_capacity_gauges(models):
    eng = _engine(False, models, kv_cache_dtype="int8")
    h = eng.submit(_prompts(9, [12])[0], max_new_tokens=3)
    eng.step()
    snap = tmetrics.snapshot("serving.kv.")
    occ = eng.cache.occupancy()
    assert snap["serving.kv.active_blocks"] == occ["active"] > 0
    assert snap["serving.kv.free_blocks"] == occ["free"]
    assert snap["serving.kv.pool_bytes"] == eng.cache.pool_bytes()
    eng.run_until_idle()
    assert h.status == RequestStatus.DONE
    eng.close()


def test_pool_bytes_matches_reference():
    from paddle_tpu.inference import paged as jpaged
    from paddle_tpu_torch.inference import paged as tpaged
    for kv in (None, "int8"):
        geo = dict(num_blocks=9, block_size=4, max_blocks_per_seq=3,
                   max_batch=2, kv_dtype=kv)
        jc = jpaged.PagedKVCache(2, 2, 8, dtype=jnp.bfloat16, **geo)
        tc = tpaged.PagedKVCache(2, 2, 8, dtype=torch.bfloat16,
                                 device="cpu", **geo)
        assert tc.pool_bytes() == jc.pool_bytes()
