"""PyTorch port: the serving frontend (``serving/``) against the JAX
package on the CPU.

- ``bucket_length`` over n = 1..4096 and ``bucket_lengths`` for several
  block sizes, caps and table lengths.
- ``ServiceTimeModel`` and ``OverloadController``: the same observations
  and queue states give the same predictions, pressures, brownout
  stages, shed victims, clamps and rejections.
- The port registers every ``serving.*`` instrument the reference's
  scheduler, cache, overload control and frontend register, and every
  instrument of its accounting and tracing modules, under the same name
  and kind (the Pallas route counters and the JAX live-array count
  excepted: the port has neither).
- ``ServingEngine`` end to end (``LlamaConfig.tiny()``, float32, the JAX
  model's parameters converted, ``background=False``; the JAX engine with
  ``accounting=False, spec=False``): the same tokens, terminal statuses,
  exceptions and ``serving.*`` / ``resilience.degrade.serving.*``
  counter deltas for shared-prefix hits, copy-on-write on a shared tail
  and on divergence, bucket padding, the budget counting uncovered
  tokens, eviction before preemption under a small pool, preemption,
  int8 pools with hits, cancel, an expired deadline, a full queue,
  priority shedding and warm-up / ``NotReadyError``; the background
  driver gives the foreground tokens, also under concurrent submits from
  many threads, and a driver that dies fails every handle loudly.
"""

import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import bucketing as jbucketing
from paddle_tpu.serving import overload as joverload
from paddle_tpu_torch import Llama, LlamaConfig, ServingEngine
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.core import resilience as tresilience
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.serving import bucketing as tbucketing
from paddle_tpu_torch.serving import overload as toverload
from paddle_tpu_torch.serving import (AdmissionRejected, NotReadyError,
                                      QueueFullError, RequestStatus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return jm, tm


# -- bucketing -------------------------------------------------------------

@pytest.mark.parametrize("block_size,cap,max_len", [
    (1, 0, 4096), (4, 64, 1000), (8, 1024, 64), (16, 1024, 2048),
    (16, 0, 2048), (16, 100, 4096), (32, 2048, 4096)])
def test_bucket_length_matches(block_size, cap, max_len):
    for n in range(1, 4097):
        for ml in (None, max_len):
            assert tbucketing.bucket_length(n, block_size, cap, ml) == \
                jbucketing.bucket_length(n, block_size, cap, ml), (n, ml)
    assert tbucketing.bucket_lengths(block_size, cap, max_len) == \
        jbucketing.bucket_lengths(block_size, cap, max_len)
    with pytest.raises(ValueError):
        tbucketing.bucket_length(0, block_size, cap)


# -- overload control ------------------------------------------------------

class _Req:
    def __init__(self, rid, priority, est, generated=()):
        self.rid, self.priority, self.est_tokens = rid, priority, est
        self.generated = list(generated)


class _Cache:
    def __init__(self, usable, active):
        self.usable, self.active = usable, active

    def occupancy(self, slice=None):
        return {"usable": self.usable, "active": self.active, "shared": 0,
                "cached_free": 0, "free": self.usable - self.active}

    def binding_slice(self):
        return None


class _Sched:
    """What the controllers read of a scheduler: the queue, the bound,
    the cache's occupancy; ``shed`` removes the victim as the scheduler
    does."""

    prefix_cache = False

    def __init__(self, queue, max_queue, cache):
        self.queue, self.max_queue, self.cache = queue, max_queue, cache
        self.shed_rids = []

    def shed(self, req, retry_after_s=None):
        self.queue.remove(req)
        self.shed_rids.append((req.rid, retry_after_s is not None))


def test_service_time_model_matches():
    pairs = [(mod.ServiceTimeModel(alpha=0.3, min_samples=2))
             for mod in (joverload, toverload)]
    for tokens, us in ((16, 800.0), (64, 2500.0), (1, 90.0)):
        for m in pairs:
            m.observe_prefill(tokens, us)
            m.observe_decode(us / 3)
        assert pairs[0].prefill_us_per_token == pairs[1].prefill_us_per_token
        assert pairs[0].decode_step_us == pairs[1].decode_step_us
        assert pairs[0].primed == pairs[1].primed
        for args in ((0, 0, 5), (40, 3, 9), (1000, 17, 0)):
            assert pairs[0].predict(*args) == pairs[1].predict(*args)


def _controller_trace(mod, deadline_cls):
    """Drive one controller through a scripted overload episode; return
    every decision it made."""
    out = []
    ctl = mod.OverloadController(admission=True, brownout=True)
    ctl.min_queue, ctl.queue_frac = 2, 0.25
    cache = _Cache(100, 10)
    queue = []
    sched = _Sched(queue, 8, cache)
    for i, (tokens, us) in enumerate(((16, 3200.0), (32, 5000.0),
                                      (8, 1600.0))):
        out.append(("primed", ctl.model.primed))
        ctl.observe_prefill(tokens, us)
        ctl.observe_decode(900.0 + i)
    rid = 0
    for step in range(12):
        # arrivals: HIGH, NORMAL and LOW in turn, a preempted one too
        for pri in (toverload.HIGH, toverload.NORMAL, toverload.LOW):
            queue.append(_Req(rid, pri, 8 + rid, generated=(
                [1] if rid == 7 else [])))
            rid += 1
        cache.active = min(100, 10 + 9 * step)
        out.append(("pressure", round(ctl.pressure(sched), 9)))
        out.append(("control", round(ctl.control(sched), 9),
                    ctl.brownout.stage, list(sched.shed_rids),
                    [r.rid for r in queue]))
        for pri, deadline in ((toverload.LOW, None),
                              (toverload.NORMAL, deadline_cls(1e-4)),
                              (toverload.HIGH, deadline_cls(3600.0))):
            try:
                est, new = ctl.admit(sched, np.zeros(20, np.int64), 40,
                                     deadline, pri)
                out.append(("admit", est, new))
            except Exception as e:  # noqa: BLE001 — the decision itself
                out.append(("reject", type(e).__name__, e.reason, e.stage,
                            e.priority, e.retry_after_s is not None))
        if step >= 7:  # the queue drains: the ladder walks back down
            queue.clear()
    out.append(("retry", ctl.queue_retry_after(sched) is not None))
    return out


def test_overload_controller_decisions_match():
    from paddle_tpu.core import resilience as jresilience
    ref = _controller_trace(joverload, jresilience.Deadline)
    out = _controller_trace(toverload, tresilience.Deadline)
    assert out == ref
    kinds = {o[0] for o in out}
    assert {"admit", "reject"} <= kinds
    assert any(o[0] == "control" and o[3] for o in out)  # something shed
    assert max(o[2] for o in out if o[0] == "control") >= 2


def test_brownout_ladder_matches():
    ctls = [mod.BrownoutController(enter_steps=2, exit_steps=3,
                                   exit_pressure=0.5)
            for mod in (joverload, toverload)]
    seq = [1.2, 1.3, 0.9, 1.0, 1.0, 1.1, 1.5, 1.5, 1.5, 1.5, 0.2, 0.6,
           0.1, 0.2, 0.3, 0.4, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0]
    assert [ctls[0].update(p) for p in seq] == \
        [ctls[1].update(p) for p in seq]


def test_null_overload_is_inert():
    assert toverload.NULL.admit(None, None, 7, None, 2) == (0, 7)
    assert toverload.NULL.control(None) == 0.0
    assert toverload.NULL.queue_retry_after(None) is None
    assert not toverload.NULL.shedding and toverload.NULL.brownout is None


# -- the metric names ------------------------------------------------------

_REG = re.compile(r'_metrics\.(counter|gauge|histogram)\(\s*"([^"]+)"')
_KINDS = {"counter": tmetrics.Counter, "gauge": tmetrics.Gauge,
          "histogram": tmetrics.Histogram}


def test_registers_the_reference_serving_metrics():
    import paddle_tpu_torch.serving  # noqa: F401 — registers them
    names = {}
    for rel in ("serving/scheduler.py", "serving/overload.py",
                "serving/frontend.py", "inference/paged.py",
                "profiler/accounting.py", "profiler/tracing.py"):
        with open(os.path.join(REPO, "paddle_tpu", rel)) as f:
            for kind, name in _REG.findall(f.read()):
                if name.startswith("serving.kernel.") or \
                        name == "memory.live_arrays":
                    continue  # the Pallas routes; JAX's live arrays
                names[name] = kind
    assert len(names) >= 60
    kinds = tmetrics.registry.kinds()
    for name, kind in names.items():
        assert kinds.get(name) is _KINDS[kind], name


def test_metrics_snapshot_arithmetic():
    h = tmetrics.histogram("test_torch.frontend.h", bounds=(1, 10, 100))
    c = tmetrics.counter("test_torch.frontend.c")
    before = tmetrics.snapshot("test_torch.frontend.")
    for v in (0.5, 5, 50, 500):
        h.observe(v)
    c.inc(3)
    d = tmetrics.window_delta(before, tmetrics.snapshot("test_torch."
                                                        "frontend."))
    assert d["test_torch.frontend.c"] == 3
    assert d["test_torch.frontend.h"]["count"] == 4
    jd = jmetrics.window_delta(before, tmetrics.snapshot("test_torch."
                                                         "frontend."))
    assert d == jd
    cum = tmetrics.cumulative_buckets(d["test_torch.frontend.h"]["buckets"])
    for q in (0.1, 0.5, 0.9, 1.0):
        assert tmetrics.percentile_from_buckets(cum, q) == \
            jmetrics.percentile_from_buckets(cum, q)


# -- ServingEngine end to end ---------------------------------------------

_DEGRADE = "resilience.degrade.serving."


def _counter_names():
    kinds = tmetrics.registry.kinds()
    return sorted(n for n, k in kinds.items() if k is tmetrics.Counter
                  and n.startswith(("serving.", _DEGRADE)))


def _snap(metrics, names):
    s = metrics.snapshot()
    return {n: s.get(n, 0) for n in names}


class _Side:
    """One package's side of a scenario: builds its engines, runs the
    steps and records handles, statuses and exceptions."""

    def __init__(self, jax_side, models):
        self.jax = jax_side
        self.model = models[0] if jax_side else models[1]
        self.handles = []
        self.events = []
        self.engines = []

    def engine(self, **kw):
        kw.setdefault("max_batch", 2)
        kw.setdefault("block_size", 8)
        kw.setdefault("max_seq_len", 64)
        kw.setdefault("background", False)
        kw.setdefault("temperature", 0.0)
        if self.jax:
            eng = JaxServingEngine(self.model, dtype=jnp.float32,
                                   accounting=False, spec=False, **kw)
        else:
            eng = ServingEngine(self.model, dtype=torch.float32, **kw)
        self.engines.append(eng)
        return eng

    def submit(self, eng, prompt, n, **kw):
        try:
            h = eng.submit(prompt, max_new_tokens=n, **kw)
        except Exception as e:  # noqa: BLE001 — compared across packages
            self.events.append(("raise", type(e).__name__))
            return None
        self.handles.append(h)
        return h

    def result(self):
        return ([h.tokens() for h in self.handles],
                [h.status for h in self.handles], self.events)


def _prompts(seed, sizes, lo=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, 255, (s,)).astype(np.int64) for s in sizes]


def _shared(seed, system_len, tails):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 255, (system_len,)).astype(np.int64)
    return [np.concatenate([system, rng.integers(0, 255, (t,))])
            for t in tails]


def scenario_prefix_hits(side):
    eng = side.engine()
    for p in _shared(22, 24, [3, 4, 5, 6]):
        side.submit(eng, p, 6)
    eng.run_until_idle()


def scenario_cow_shared_tail(side):
    eng = side.engine()
    p = _prompts(23, [20])[0]
    side.submit(eng, p, 8)
    side.submit(eng, p.copy(), 8)
    eng.run_until_idle()
    side.events.append(("shared", eng.cache.num_shared_blocks()))


def scenario_cow_divergence(side):
    eng = side.engine()
    a = _prompts(24, [20])[0]
    b = np.concatenate([a, _prompts(25, [9])[0]])
    side.submit(eng, a, 6)
    eng.step()  # a's chunks registered before b plans
    side.submit(eng, b, 6)
    eng.run_until_idle()


def scenario_bucket_padding(side):
    eng = side.engine()
    a = _prompts(26, [10], lo=1)[0]                 # pads to 16
    b = np.concatenate([a, np.zeros(6, np.int64)])  # its padded form
    side.submit(eng, a, 6)
    eng.step()
    plan = eng.cache.plan_prefix(b)
    side.events.append(("plan", plan.matched_full, plan.partial_len,
                        plan.partial_shared))
    side.submit(eng, b, 6)
    eng.run_until_idle()


def scenario_budget_uncovered(side):
    eng = side.engine(max_batch=4, prefill_token_budget=8)
    prompts = _shared(27, 24, [2, 2, 2])
    side.submit(eng, prompts[0], 2)
    eng.run_until_idle()
    for p in prompts[1:]:
        side.submit(eng, p, 2)
    eng.step()
    side.events.append(("after_one_step", len(eng.scheduler.queue)))
    eng.run_until_idle()


def scenario_evict_before_preempt(side):
    eng = side.engine(block_size=4, max_seq_len=32, num_blocks=11)
    a, p1, p2 = _prompts(28, [8, 8, 8])
    side.submit(eng, a, 4)
    eng.run_until_idle()
    side.events.append(("cached", eng.cache.num_cached_blocks()))
    side.submit(eng, p1, 12)
    side.submit(eng, p2, 12)
    eng.run_until_idle()


def scenario_preemption(side):
    eng = side.engine(block_size=4, max_seq_len=32, num_blocks=9,
                      prefix_cache=False)
    for p in _prompts(29, [7, 9, 6]):
        side.submit(eng, p, 14)
    eng.run_until_idle()
    side.events.append(("preempts", [h.preempts for h in side.handles]))


def scenario_int8_hits(side):
    eng = side.engine(kv_cache_dtype="int8")
    prompts = _shared(30, 16, [3, 3, 9])
    prompts.append(prompts[0].copy())
    for p in prompts:
        side.submit(eng, p, 5)
    eng.run_until_idle()


def scenario_cancel(side):
    eng = side.engine(max_batch=1)
    hs = [side.submit(eng, p, 8) for p in _prompts(31, [9, 7, 5])]
    eng.step()
    hs[0].cancel()   # running
    hs[1].cancel()   # queued
    eng.run_until_idle()
    side.events.append(("free", eng.cache.num_free_blocks()))


def scenario_deadline(side):
    eng = side.engine(max_batch=1)
    p1, p2 = _prompts(32, [9, 7])
    side.submit(eng, p1, 8, deadline_s=0.0)   # expired while queued
    side.submit(eng, p2, 4)
    eng.run_until_idle()


def scenario_queue_full(side):
    eng = side.engine(max_batch=1, max_queue=2)
    for p in _prompts(33, [5, 6, 7]):
        side.submit(eng, p, 3)
    eng.run_until_idle()
    side.submit(eng, _prompts(34, [4])[0], 2)
    side.submit(eng, np.zeros((0,), np.int64), 2)     # empty prompt
    side.submit(eng, _prompts(35, [60])[0], 10)       # past max_seq_len
    eng.run_until_idle()


def scenario_shedding(side):
    eng = side.engine(max_queue=8, bucket_cap=32)
    for p in _prompts(36, [5, 5, 5]):   # prime the service-time model
        side.submit(eng, p, 2)
        eng.run_until_idle()
    ov = eng.scheduler.overload
    ov.min_queue, ov.queue_frac = 2, 0.25
    for seed, pri in ((37, 0), (38, 1), (39, 2)):
        for p in _prompts(seed, [5, 6, 7]):
            side.submit(eng, p, 3, priority=pri)
    eng.run_until_idle()


def scenario_warmup(side):
    eng = side.engine(ready=False)
    side.submit(eng, _prompts(40, [5])[0], 3)
    side.events.append(("lifecycle", eng.lifecycle))
    side.events.append(("warmup", eng.warmup()))
    side.events.append(("lifecycle", eng.lifecycle))
    side.events.append(("free", eng.cache.num_free_blocks()))
    for p in _prompts(41, [5, 13]):
        side.submit(eng, p, 4)
    eng.run_until_idle()
    eng.drain()
    side.events.append(("lifecycle", eng.lifecycle))
    side.submit(eng, _prompts(42, [5])[0], 3)


SCENARIOS = [scenario_prefix_hits, scenario_cow_shared_tail,
             scenario_cow_divergence, scenario_bucket_padding,
             scenario_budget_uncovered, scenario_evict_before_preempt,
             scenario_preemption, scenario_int8_hits, scenario_cancel,
             scenario_deadline, scenario_queue_full, scenario_shedding,
             scenario_warmup]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[9:] for s in SCENARIOS])
def test_serving_engine_matches_reference(models, scenario):
    names = _counter_names()
    out = {}
    for jax_side in (True, False):
        side = _Side(jax_side, models)
        metrics = jmetrics if jax_side else tmetrics
        before = _snap(metrics, names)
        scenario(side)
        after = _snap(metrics, names)
        for eng in side.engines:
            eng.close()
        out[jax_side] = side.result() + (
            {n: after[n] - before[n] for n in names},)
    assert out[False] == out[True]
    tokens, statuses, events, deltas = out[False]
    assert all(s in RequestStatus.TERMINAL for s in statuses)
    assert deltas["serving.admitted"] > 0


def test_scenarios_exercise_their_paths(models):
    """The parity runs above are only worth their cases: each scenario
    moves the counters it is named after."""
    runs = {}
    for sc in (scenario_prefix_hits, scenario_cow_shared_tail,
               scenario_cow_divergence, scenario_evict_before_preempt,
               scenario_preemption, scenario_cancel, scenario_deadline,
               scenario_queue_full, scenario_shedding, scenario_warmup):
        side = _Side(False, models)
        names = _counter_names()
        before = _snap(tmetrics, names)
        sc(side)
        after = _snap(tmetrics, names)
        runs[sc.__name__[9:]] = ({n: after[n] - before[n] for n in names},
                                 side)
    d = {k: v[0] for k, v in runs.items()}
    assert d["prefix_hits"]["serving.prefix.hit_blocks"] >= 9
    assert d["cow_shared_tail"]["serving.prefix.cow_copies"] == 1
    assert d["cow_divergence"]["serving.prefix.cow_copies"] == 1
    assert d["evict_before_preempt"]["serving.prefix.evictions"] >= 2
    assert d["evict_before_preempt"]["serving.preempt"] == 0
    assert d["preemption"]["serving.preempt"] > 0
    assert d["cancel"]["serving.cancelled"] == 2
    assert d["deadline"]["serving.timeout"] == 1
    assert d["queue_full"]["serving.rejected"] == 1
    assert d["shedding"]["serving.shed"] > 0
    assert d["warmup"]["serving.warmup.programs"] == 5  # 4 buckets + decode
    assert d["warmup"]["serving.drain.completed"] == 1
    assert ("raise", NotReadyError.__name__) in runs["warmup"][1].events
    assert ("raise", QueueFullError.__name__) in runs["queue_full"][1].events


def test_background_driver_gives_foreground_tokens(models):
    _, tm = models
    prompts = _shared(43, 16, [3, 5]) + _prompts(44, [11])
    fg = ServingEngine(tm, max_batch=2, block_size=8, max_seq_len=64,
                       dtype=torch.float32, background=False)
    hs = [fg.submit(p, max_new_tokens=5) for p in prompts]
    fg.run_until_idle()
    want = [h.tokens() for h in hs]
    streamed = []
    with ServingEngine(tm, max_batch=2, block_size=8, max_seq_len=64,
                       dtype=torch.float32) as bg:
        hs = [bg.submit(p, max_new_tokens=5) for p in prompts]
        streamed = list(hs[0].stream(timeout=60))
        got = [h.result(timeout=60) for h in hs]
        assert bg._thread is not None and bg._thread.is_alive()
    assert got == want and streamed == want[0]
    assert all(h.status == RequestStatus.DONE for h in hs)


def test_unported_options_raise(models):
    _, tm = models
    kw = dict(max_batch=1, block_size=8, max_seq_len=32,
              dtype=torch.float32, background=False)
    for extra in (dict(mesh="1x2"), dict(role="prefill")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(tm, **kw, **extra)
    # accounting and speculative decode are ported; the telemetry slice's
    # alerts and metrics endpoint raise rather than return None
    eng = ServingEngine(tm, accounting=True, spec=True, **kw)
    assert eng.accounting.armed and eng.scheduler.spec
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.alerts
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.serve_metrics()
    eng.close()


def test_admission_rejects_unmeetable_deadline(models):
    _, tm = models
    eng = ServingEngine(tm, max_batch=2, block_size=8, max_seq_len=64,
                        dtype=torch.float32, background=False)
    for p in _prompts(45, [5, 5, 5]):
        eng.submit(p, max_new_tokens=2)
        eng.run_until_idle()
    assert eng.scheduler.overload.model.primed
    with pytest.raises(AdmissionRejected) as e:
        eng.submit(_prompts(46, [9])[0], max_new_tokens=4, deadline_s=1e-9)
    assert e.value.reason == "deadline" and e.value.retry_after_s > 0
    h = eng.submit(_prompts(47, [9])[0], max_new_tokens=4, deadline_s=600)
    eng.run_until_idle()
    assert h.status == RequestStatus.DONE


def test_concurrent_submits_from_threads(models):
    """16 submits from 8 threads into a background engine, the
    interpreter switching threads every microsecond: every request ends
    DONE with the tokens it gets alone, under a distinct rid."""
    _, tm = models
    prompts = _prompts(48, [5, 8, 11, 6, 9, 7, 10, 4, 12, 3, 9, 6, 5, 8,
                            7, 13])
    kw = dict(max_batch=2, block_size=8, max_seq_len=64,
              dtype=torch.float32)
    refs = []
    for p in prompts:
        eng = ServingEngine(tm, background=False, **kw)
        h = eng.submit(p, max_new_tokens=5)
        eng.run_until_idle()
        refs.append(h.tokens())
    handles = [None] * len(prompts)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ServingEngine(tm, **kw) as eng:
            def worker(i):
                for j in (2 * i, 2 * i + 1):
                    handles[j] = eng.submit(prompts[j], max_new_tokens=5)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(prompts) // 2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            got = [h.result(timeout=120) for h in handles]
    finally:
        sys.setswitchinterval(old)
    assert got == refs
    assert all(h.status == RequestStatus.DONE for h in handles)
    assert len({h.rid for h in handles}) == len(handles)


def test_engine_death_fails_loud(models):
    """If the driver thread dies, stream(), result() and submit() raise
    the cause: truncated output never looks complete."""
    _, tm = models
    eng = ServingEngine(tm, max_batch=1, block_size=8, max_seq_len=64,
                        dtype=torch.float32)

    def broken(*a, **k):
        raise RuntimeError("injected device failure")

    tm.paged_decode_step = broken
    try:
        h = eng.submit(np.arange(5), max_new_tokens=8)
        with pytest.raises(RuntimeError, match="injected"):
            list(h.stream(timeout=60))
        assert h.status == RequestStatus.ERROR
        with pytest.raises(RuntimeError, match="injected"):
            h.result(timeout=1)
        with pytest.raises(RuntimeError, match="died"):
            eng.submit(np.arange(4), max_new_tokens=2)
    finally:
        del tm.paged_decode_step
