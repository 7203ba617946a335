"""PyTorch port: request tracing (``profiler/tracing.py``) and histogram
exemplars (``profiler/metrics.py``) against the JAX package on the CPU.

- Span mechanics: nesting through the ambient context, explicit parents
  across threads, ``record_span`` after the fact, ``attach`` of a
  propagation dict, ring wrap-around, the disabled path
  (``FLAGS_trace_enable=0``: the null span, nothing recorded) and
  sampled-out roots (``FLAGS_trace_sample``), each as the reference
  behaves.
- ``ServingEngine`` (``LlamaConfig.tiny()``, float32, the JAX model's
  parameters converted, default flags): each request's spans (names,
  parent links, attributes and statuses; not ids, times or durations)
  equal the JAX engine's: plain decode, speculative decode, preemption
  with re-prefill, prefix hits, cancellation and shedding; ``warmup`` and
  ``drain`` record their spans; ``export_trace`` is trace-event JSON.
- Exemplars: a histogram observed inside a trace keeps the trace id per
  bucket, and the ``serving.*`` SLO histograms' exemplars name a trace
  the ring exports.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import tracing as jtracing
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import Llama, LlamaConfig, ServingEngine
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.core.flags import flag, set_flags
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.profiler import tracing as ttracing
from paddle_tpu_torch.serving import scheduler as tscheduler
from paddle_tpu_torch.serving.spec import repetitive_prompts

TRACE_FLAGS = ("FLAGS_trace_enable", "FLAGS_trace_sample",
               "FLAGS_trace_ring")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jm.eval()
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return jm, tm


@pytest.fixture
def trace_flags():
    """Restore the tracing flags of both packages after a test."""
    saved = {n: flag(n) for n in TRACE_FLAGS}
    jsaved = paddle.get_flags(list(TRACE_FLAGS))
    yield
    set_flags(saved)
    paddle.set_flags(jsaved)


def _names(recs):
    return [r["name"] for r in recs]


# -- span mechanics --------------------------------------------------------

def test_span_nesting_and_ambient_context():
    root = ttracing.start_trace("t.root", rid=1)
    assert root.recording and root.trace_id and root.parent_id is None
    with ttracing.span("t.child", parent=root) as child:
        assert ttracing.current_trace_id() == root.trace_id
        with ttracing.span("t.grand") as grand:  # the ambient parent
            assert grand.parent_id == child.span_id
    ttracing.record_span("r.slice", root, 1234.5, step=7)
    ctx = root.context()
    with ttracing.attach(ctx):
        assert ttracing.current_context() == ctx
        with ttracing.span("r.adopted") as sp:
            assert sp.trace_id == root.trace_id
    assert ttracing.current_context() is None
    assert ttracing.span("orphan") is ttracing.NULL  # no parent anywhere
    root.end()
    root.end("twice")  # idempotent
    tr = ttracing.get_trace(root.trace_id)
    by = {r["name"]: r for r in tr}
    assert set(by) == {"t.root", "t.child", "t.grand", "r.slice",
                       "r.adopted"}
    assert by["r.slice"]["dur"] == pytest.approx(1234.5)
    assert by["r.slice"]["args"] == {"step": 7}
    assert by["r.adopted"]["parent"] == root.span_id
    assert by["t.root"]["status"] == "ok" and by["t.root"]["args"] == {
        "rid": 1}
    assert root.trace_id in ttracing.trace_ids()


def test_explicit_parent_across_threads():
    root = ttracing.start_trace("x.root")
    ids = []

    def worker(i):
        with ttracing.span("x.worker", parent=root, i=i) as sp:
            ids.append(sp.parent_id)
        ttracing.record_span("x.after", root.context(), 1.0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    root.end()
    assert ids == [root.span_id] * 4
    names = _names(ttracing.get_trace(root.trace_id))
    # record_span takes a Span only: a dict parent records nothing, as in
    # the reference
    assert names.count("x.worker") == 4 and "x.after" not in names


def test_disabled_and_sampled_out(trace_flags):
    for mod, setf in ((ttracing, set_flags), (jtracing, paddle.set_flags)):
        setf({"FLAGS_trace_enable": False})
        n0 = len(mod.records())
        assert mod.start_trace("off.root") is mod.NULL
        assert mod.span("off.child") is mod.NULL
        assert not mod.enabled()
        with mod.span("off.ctx"):
            assert mod.current_trace_id() is None
        mod.record_span("off.slice", mod.NULL, 1.0)
        assert len(mod.records()) == n0
        setf({"FLAGS_trace_enable": True, "FLAGS_trace_sample": 0.0})
        assert mod.start_trace("s.root") is mod.NULL  # rate 0: disarmed
        setf({"FLAGS_trace_sample": 1e-9})
    before = tmetrics.counter("trace.unsampled").value
    roots = [ttracing.start_trace("s.root") for _ in range(50)]
    assert all(r is ttracing.NULL for r in roots)
    assert tmetrics.counter("trace.unsampled").value - before == 50
    assert ttracing.span("s.child", parent=roots[0]) is ttracing.NULL
    assert not ttracing.NULL and ttracing.NULL.trace_id is None


def test_ring_wraparound(trace_flags):
    set_flags({"FLAGS_trace_ring": 8})
    try:
        for i in range(20):
            ttracing.start_trace(f"w.{i}").end()
        assert _names(ttracing.records()) == [f"w.{i}" for i in
                                              range(12, 20)]
    finally:
        set_flags({"FLAGS_trace_ring": 4096})
    assert ttracing.enabled()  # the next entry point resizes: it clears
    assert ttracing.records() == []


def test_export_formats():
    root = ttracing.start_trace("e.root", rid=3)
    ttracing.record_span("e.slice", root, 5.0, k=1)
    root.end("DONE")
    doc = json.loads(json.dumps(ttracing.export_trace(root.trace_id)))
    assert doc["trace_id"] == root.trace_id
    assert doc["displayTimeUnit"] == "ms"
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["e.slice"]["ph"] == "X" and ev["e.slice"]["args"]["k"] == 1
    assert ev["e.slice"]["args"]["parent_id"] == root.span_id
    assert ev["e.root"]["args"]["status"] == "DONE"
    ring = json.loads(json.dumps(ttracing.export_ring()))
    assert len(ring["traceEvents"]) == len(ttracing.records())


# -- the serving request path ------------------------------------------------

def _engine(jax_side, models, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("background", False)
    kw.setdefault("temperature", 0.0)
    if jax_side:
        return JaxServingEngine(models[0], dtype=jnp.float32, **kw)
    return ServingEngine(models[1], dtype=torch.float32, **kw)


def _tree(mod, trace_id):
    """One trace without ids and times: (name, parent's name, status,
    args) per span, sorted."""
    tr = mod.get_trace(trace_id)
    by_id = {r["span"]: r["name"] for r in tr}
    return sorted((r["name"], by_id.get(r["parent"]), r["status"],
                   json.dumps(r.get("args"), sort_keys=True)) for r in tr)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 250, (s,)).astype(np.int64) for s in sizes]


def trace_plain(make, submit):
    eng = make()
    for p in _prompts(0, [6, 11, 5]):
        submit(p, 5)
    eng.run_until_idle()


def trace_spec(make, submit):
    eng = make(max_batch=4, bucket_cap=32, spec=True)
    for p in repetitive_prompts():
        submit(p, 12)
    eng.run_until_idle()


def trace_preemption(make, submit):
    eng = make(block_size=4, max_seq_len=32, num_blocks=8)
    for p in _prompts(1, [8, 8]):
        submit(p, 12)
    eng.run_until_idle()


def trace_prefix_hits(make, submit):
    eng = make(bucket_cap=32)
    rng = np.random.default_rng(2)
    system = rng.integers(0, 255, (24,)).astype(np.int64)
    for _ in range(3):
        submit(np.concatenate([system, rng.integers(0, 255, (3,))]), 4)
    eng.run_until_idle()


def trace_cancel_and_shed(make, submit):
    eng = make(max_queue=8, bucket_cap=32)
    for p in _prompts(36, [5, 5, 5]):   # prime the service-time model
        submit(p, 2)
        eng.run_until_idle()
    ov = eng.scheduler.overload
    ov.min_queue, ov.queue_frac = 2, 0.25
    hs = [submit(p, 3, priority=pri)
          for pri, p in zip((0, 1, 2, 2, 1, 0), _prompts(37, [5, 6, 7] * 2))]
    eng.step()
    hs[1].cancel()
    eng.run_until_idle()


TRACE_SCENARIOS = [trace_plain, trace_spec, trace_preemption,
                   trace_prefix_hits, trace_cancel_and_shed]


def _traces(jax_side, models, scenario):
    handles = []
    holder = {}

    def make(**kw):
        holder["eng"] = _engine(jax_side, models, **kw)
        return holder["eng"]

    def submit(prompt, n, **kw):
        h = holder["eng"].submit(prompt, max_new_tokens=n, **kw)
        handles.append(h)
        return h

    scenario(make, submit)
    holder["eng"].close()
    mod = jtracing if jax_side else ttracing
    return [(h.status, _tree(mod, h.trace_id)) for h in handles]


@pytest.mark.parametrize("scenario", TRACE_SCENARIOS,
                         ids=[s.__name__[6:] for s in TRACE_SCENARIOS])
def test_request_traces_match_reference(models, scenario):
    ref = _traces(True, models, scenario)
    got = _traces(False, models, scenario)
    assert got == ref
    for status, tree in got:
        names = [t[0] for t in tree]
        root = [t for t in tree if t[0] == "serving.request"]
        assert len(root) == 1 and root[0][1] is None
        assert root[0][2] == status
        assert all(t[1] == "serving.request" for t in tree
                   if t[0] != "serving.request")
        assert "serving.terminal" in names
    names = [t[0] for _, tree in got for t in tree]
    if scenario is trace_spec:
        args = [json.loads(t[3]) for _, tree in got for t in tree
                if t[0] == "serving.decode_step"]
        assert sum(a.get("spec_accepted", 0) for a in args) > 0
    if scenario is trace_preemption:
        assert "serving.preempt" in names
    if scenario is trace_cancel_and_shed:
        assert "serving.shed" in names


def test_request_trace_content_and_export(models):
    eng = _engine(False, models)
    h = eng.submit(_prompts(4, [6])[0], max_new_tokens=5)
    eng.run_until_idle()
    assert h.status == "DONE" and h.trace_id is not None
    tr = ttracing.get_trace(h.trace_id)
    names = _names(tr)
    assert names.count("serving.request") == 1
    assert names.count("serving.decode_step") == 4
    assert {"serving.queue_wait", "serving.prefill",
            "serving.terminal"} <= set(names)
    root = next(r for r in tr if r["name"] == "serving.request")
    assert root["status"] == "DONE" and root["args"]["tokens"] == 5
    assert root["parent"] is None
    assert all(r["parent"] == root["span"] for r in tr if r is not root)
    assert all(r["route"] == "dense" for r in
               (x["args"] for x in tr if x["name"] == "serving.decode_step"))
    doc = json.loads(json.dumps(ttracing.export_trace(h.trace_id)))
    assert len(doc["traceEvents"]) == len(tr)
    assert all(e["ph"] == "X" and e["args"]["trace_id"] == h.trace_id
               for e in doc["traceEvents"])
    eng.close()


def test_tracing_off_engine_serves_untraced(models, trace_flags):
    set_flags({"FLAGS_trace_enable": False})
    n0 = len(ttracing.records())
    eng = _engine(False, models)
    h = eng.submit(_prompts(5, [7])[0], max_new_tokens=4)
    eng.run_until_idle()
    eng.close()
    assert h.status == "DONE" and h.trace_id is None
    assert len(ttracing.records()) == n0


def test_warmup_and_drain_spans(models):
    for jax_side in (True, False):
        mod = jtracing if jax_side else ttracing
        mod.reset()
        root = mod.start_trace("boot")
        eng = _engine(jax_side, models, ready=False)
        with mod.attach(root):
            eng.warmup()
        eng.submit(_prompts(6, [5])[0], max_new_tokens=2)
        eng.drain()
        root.end()
        warm = [r for r in mod.get_trace(root.trace_id)
                if r["name"] == "serving.warmup"]
        assert len(warm) == 1 and warm[0]["args"]["buckets"] == 4
        drains = [r for r in mod.records() if r["name"] == "serving.drain"]
        assert len(drains) == 1
        assert drains[0]["status"] == "CLOSED"
        assert drains[0]["args"] == {"inflight": 1, "completed": True}


# -- exemplars ---------------------------------------------------------------

def test_histogram_exemplars_carry_the_trace_id():
    h = tmetrics.histogram("test_torch.tracing.h", bounds=(1, 10))
    h.observe(0.5)  # outside any trace: no exemplar
    root = ttracing.start_trace("ex.root")
    with ttracing.attach(root):
        h.observe(5)
        h.observe(3)
    root.end()
    ex = tmetrics.snapshot("test_torch.tracing.")[
        "test_torch.tracing.h"]["exemplars"]
    assert set(ex) == {"10"}
    assert ex["10"]["value"] == 5 and ex["10"]["trace_id"] == root.trace_id
    # exemplars are point-in-time: window deltas drop them
    d = tmetrics.window_delta({}, tmetrics.snapshot("test_torch.tracing."))
    assert "exemplars" not in d["test_torch.tracing.h"]


def test_serving_exemplars_resolve_to_exportable_traces(models,
                                                        monkeypatch):
    # fresh SLO histograms: exemplars keep each bucket's largest value
    # ever, which earlier traffic in this process may hold
    fresh = {}
    for attr in ("_h_ttft", "_h_itl", "_h_queue_wait", "_h_spec_accept"):
        old = getattr(tscheduler, attr)
        fresh[attr] = tmetrics.Histogram(old.name, bounds=old.bounds)
        monkeypatch.setattr(tscheduler, attr, fresh[attr])
    eng = _engine(False, models, max_batch=4, bucket_cap=32, spec=True)
    hs = [eng.submit(p, max_new_tokens=12) for p in repetitive_prompts()]
    eng.run_until_idle()
    eng.close()
    ids = {h.trace_id for h in hs}
    assert None not in ids
    for attr, hist in fresh.items():
        exs = hist._snap()["exemplars"]
        assert exs, attr
        assert {e["trace_id"] for e in exs.values()} <= ids
    worst = max(fresh["_h_ttft"]._snap()["exemplars"].values(),
                key=lambda e: e["value"])
    slowest = max(hs, key=lambda h: h.cost().ttft_us)
    assert worst["trace_id"] == slowest.trace_id
    assert ttracing.export_trace(worst["trace_id"])["traceEvents"]
