"""PyTorch port: the telemetry export surface (``profiler/export.py``)
against the JAX package on the CPU.

- ``render_prometheus`` gives the JAX package's text for the same
  counters, gauges and histograms (registered in each package's registry
  under a prefix no other test uses); with exemplars, whose trace ids
  differ between the packages, the two parse to the same data but for
  the ids, and each id names a trace its package exports.
- ``parse_prometheus`` / ``render_parsed`` round-trip, labels and
  exemplars included; a malformed line raises.
- ``DeltaRates``: per-second rates, the negative-delta clamp on monotone
  series (a counter reset reads 0), a gauge's sign kept, bucket rates.
- ``MetricsServer`` on a tiny CPU ``ServingEngine`` (mirroring
  ``tests/framework/test_tracing.py:330``): every route, the ephemeral
  port, 404s, ``/healthz`` 503 once the driver died, ``/readyz`` 503 out
  of READY, and the endpoint gone after ``close()``. Every HTTP call has
  a timeout and every server is closed.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import export as jexport
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler import tracing as jtracing
from paddle_tpu_torch import Llama, LlamaConfig, ServingEngine
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.profiler import export, metrics, tracing

_PREFIX = "t14export."


def _fill(mod, tr, name, traced):
    """The same instruments and observations in one package's registry;
    with ``traced`` the histogram's 7.0 lands inside a trace."""
    mod.counter(f"{_PREFIX}{name}.ctr").inc(3)
    mod.gauge(f"{_PREFIX}{name}.g").set(2.5)
    mod.gauge(f"{_PREFIX}{name}.gi").set(-4)
    h = mod.histogram(f"{_PREFIX}{name}.h", bounds=(1, 10, 100.5))
    h.observe(0.5)
    h.observe(1e6)
    root = None
    if traced:
        root = tr.start_trace("export.root")
        with tr.attach(root):
            h.observe(7.0)
        root.end()
    else:
        h.observe(7.0)
    return root


def test_render_prometheus_text_matches_jax():
    _fill(jmetrics, jtracing, "plain", False)
    _fill(metrics, tracing, "plain", False)
    want = jexport.render_prometheus(prefix=_PREFIX + "plain.")
    got = export.render_prometheus(prefix=_PREFIX + "plain.")
    assert got == want
    assert got.rstrip().endswith("# EOF")
    assert "t14export_plain_ctr_total 3" in got


def test_exemplars_parse_the_same_but_for_trace_ids():
    jroot = _fill(jmetrics, jtracing, "ex", True)
    troot = _fill(metrics, tracing, "ex", True)
    want = jexport.parse_prometheus(
        jexport.render_prometheus(prefix=_PREFIX + "ex."))
    got = export.parse_prometheus(
        export.render_prometheus(prefix=_PREFIX + "ex."))
    assert set(got) == set(want)
    h = _PREFIX.replace(".", "_") + "ex_h"
    assert got[h]["exemplars"]["10"]["trace_id"] == troot.trace_id
    assert want[h]["exemplars"]["10"]["trace_id"] == jroot.trace_id
    assert tracing.export_trace(troot.trace_id)["traceEvents"]
    for d in (got, want):
        for e in d[h]["exemplars"].values():
            e.pop("trace_id")
    assert got == want


def test_full_render_carries_identity_and_parses():
    text = export.render_prometheus()
    parsed = export.parse_prometheus(text)
    info = [k for k in parsed if k.startswith("replica_info")]
    assert len(info) == 1
    labels = parsed[info[0]]["labels"]
    assert set(labels) == {"replica_id", "host", "pid", "start_ts"}
    assert labels == {k: str(v) for k, v in
                      metrics.replica_identity().items()}


def test_parse_render_round_trip_with_labels():
    _fill(metrics, tracing, "rt", True)
    text = export.render_prometheus(prefix=_PREFIX + "rt.",
                                    labels={"replica": 'r"1'})
    parsed = export.parse_prometheus(text)
    again = export.parse_prometheus(export.render_parsed(parsed))
    assert again == parsed
    key = next(k for k in parsed if k.startswith(
        _PREFIX.replace(".", "_") + "rt_ctr"))
    assert parsed[key]["labels"] == {"replica": 'r"1'}
    # the same text through the JAX package's parser
    assert jexport.parse_prometheus(text) == parsed
    with pytest.raises(ValueError, match="unparseable"):
        export.parse_prometheus("not a sample line at all {")


def test_delta_rates_clamp_sign_and_buckets():
    name = _PREFIX + "delta."
    c = metrics.counter(name + "ctr")
    g = metrics.gauge(name + "g")
    h = metrics.histogram(name + "h", bounds=(1, 10))
    d = export.DeltaRates(prefix=name, include_buckets=True)
    assert d.rates() == {}  # the first call primes
    c.inc(10)
    g.set(5)
    h.observe(3)
    r = d.rates()
    assert r[name + "ctr"] > 0 and r[name + "g"] > 0
    assert r[name + "h.count"] > 0 and r[name + "h.le.10"] > 0
    assert r[name + "h.le.1"] == 0
    g.set(1)  # a shrinking gauge is a negative derivative
    r = d.rates()
    assert r[name + "g"] < 0 and r[name + "ctr"] == 0
    # a counter reset (a fresh process behind the same endpoint) reads 0
    d._prev[name + "ctr"] += 1000
    d._prev[name + "h.le.10"] += 5
    r = d.rates()
    assert r[name + "ctr"] == 0 and r[name + "h.le.10"] == 0
    assert not any(k.startswith(name + "h.le.") for k in
                   export.DeltaRates(prefix=name).rates())


@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return tm


def _get(srv, path):
    with urllib.request.urlopen(srv.url(path), timeout=10) as r:
        return r.status, r.read().decode()


def _code(srv, path):
    try:
        return _get(srv, path)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_metrics_server_routes_on_a_serving_engine(model):
    eng = ServingEngine(model, max_batch=2, block_size=8, max_seq_len=64,
                        dtype=torch.float32, background=False, ready=False)
    srv = eng.serve_metrics(port=0)
    try:
        assert eng.serve_metrics() is srv
        assert srv.port > 0 and srv.address == ("127.0.0.1", srv.port)
        assert srv.url("/x") == f"http://127.0.0.1:{srv.port}/x"
        assert _code(srv, "/readyz") == 503  # WARMING
        eng.mark_ready()
        rng = np.random.default_rng(3)
        h = eng.submit(rng.integers(0, 256, 6).astype(np.int64),
                       max_new_tokens=3)
        eng.run_until_idle()
        code, text = _get(srv, "/metrics")
        assert code == 200 and text.rstrip().endswith("# EOF")
        parsed = export.parse_prometheus(text)
        for name, v in metrics.snapshot("serving.").items():
            if metrics.registry.kinds().get(name) is metrics.Counter:
                assert parsed[export._pname(name)]["value"] == v, name
        code, body = _get(srv, "/metrics/delta")
        assert code == 200 and isinstance(json.loads(body), dict)
        code, body = _get(srv, "/healthz")
        hz = json.loads(body)
        assert code == 200 and hz["status"] == "ok"
        assert hz["engine"]["lifecycle"] == "READY"
        assert "serving.queue.depth" in hz["slo"]
        code, body = _get(srv, "/readyz")
        assert code == 200 and json.loads(body)["ready"] is True
        code, body = _get(srv, "/alerts")
        assert code == 200 and json.loads(body)["attached"] is True
        code, text = _get(srv, "/summary")
        assert code == 200 and "Serving / SLO View" in text
        code, body = _get(srv, "/traces")
        assert code == 200 and json.loads(body)["traceEvents"]
        code, body = _get(srv, f"/traces/{h.trace_id}")
        assert code == 200 and json.loads(body)["traceEvents"]
        assert _code(srv, "/traces/nope") == 404
        assert _code(srv, "/nothing") == 404
        eng._error = RuntimeError("driver died")  # as a dead driver
        try:
            code = _code(srv, "/healthz")
            assert code == 503
        finally:
            eng._error = None
        eng.drain()
        assert _code(srv, "/readyz") == 503  # CLOSED
    finally:
        eng.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url("/healthz"), timeout=2)


def test_standalone_server_has_the_same_alerts_shape():
    with export.MetricsServer() as srv:
        body = json.loads(_get(srv, "/alerts")[1])
        assert body == {"attached": False, "active": [], "history": [],
                        "rules": [], "window_s": None}
        ready = json.loads(_get(srv, "/readyz")[1])
        assert ready["ready"] is True and ready["attached"] is False


def test_reset_of_one_family_zeroes_it_and_drops_exemplars():
    root = _fill(metrics, tracing, "reset", True)
    name = _PREFIX + "reset.h"
    assert metrics.snapshot(name)[name]["exemplars"]["10"]["trace_id"] \
        == root.trace_id
    other = metrics.counter(_PREFIX + "keep.ctr")
    other.inc(2)
    metrics.reset(name)
    h = metrics.snapshot(name)[name]
    assert h["count"] == 0 and h["exemplars"] == {}
    assert other.value == 2
    metrics.reset(_PREFIX + "reset.")
    assert metrics.counter(_PREFIX + "reset.ctr").value == 0
