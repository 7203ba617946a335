"""PyTorch port: the SLO alert rules and their manager
(``profiler/alerts.py``) against the JAX package on the CPU.

- Every default rule's ``evaluate(ctx)`` on the same hand-built ``{rates,
  snap, dt}`` gives the same ``(firing, info)`` in both packages: the burn
  rate's budget snapped up to a bucket bound, ``+inf`` within budget only
  when the budget itself snapped to it, the minimum sample count; queue
  depth and growth; a stall only while stepping; shedding.
- The manager on the port's registry: edge-triggered firing, resolve into
  history, a new episode refiring, one ``alert.<rule>`` flight record an
  episode, the ``FLAGS_alert_interval_s`` rate limit.
- The scheduler's nudge (mirroring ``tests/framework/test_accounting.py``
  :448-536): an armed engine holds an ``AlertManager`` and evaluates at
  step boundaries, concurrent ``/alerts`` scrapers consume no extra
  window, and the endpoint serves the manager.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.profiler import alerts as jalerts
from paddle_tpu_torch import Llama, LlamaConfig, ServingEngine
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.profiler import alerts, metrics

_ALERT_FLAGS = ("FLAGS_slo_ttft_budget_us", "FLAGS_slo_itl_budget_us",
                "FLAGS_slo_target", "FLAGS_alert_burn_threshold",
                "FLAGS_alert_interval_s", "FLAGS_alert_queue_depth")


@pytest.fixture
def both_flags():
    """Set flags in both packages; restored after the test."""
    saved_j = paddle.get_flags(list(_ALERT_FLAGS))
    saved_t = tflags.get_flags(list(_ALERT_FLAGS))

    def set_both(**kw):
        flags = {f"FLAGS_{k}": v for k, v in kw.items()}
        paddle.set_flags(flags)
        tflags.set_flags(flags)
    yield set_both
    paddle.set_flags(saved_j)
    tflags.set_flags(saved_t)


_BOUNDS = (1000, 10000, 100000, 250000, 1000000)


def _hist_rates(name, per_bucket, dt=1.0):
    """Per-second rates of one histogram: counts per bucket label (the
    five bounds, then +inf) and the total."""
    labels = [*map(str, _BOUNDS), "+inf"]
    rates = {f"{name}.le.{lab}": c / dt for lab, c in zip(labels,
                                                         per_bucket)}
    rates[name + ".count"] = sum(per_bucket) / dt
    return rates


def _ctx(rates=None, snap=None, dt=1.0):
    now = time.time()
    exemplars = {"250000": {"value": 200000.0, "trace_id": "t-old",
                            "ts": now - 3600},
                 "1000000": {"value": 900000.0, "trace_id": "t-worst",
                             "ts": now},
                 "100000": {"value": 90000.0, "trace_id": "t-fast",
                            "ts": now}}
    base = {name: {"exemplars": dict(exemplars)} for name in
            ("serving.ttft_us", "serving.itl_us", "serving.queue_wait_us")}
    base.update(snap or {})
    return {"rates": rates or {}, "snap": base, "dt": dt}


# name: (flags, ctx kwargs); the names of cases where no rule fires end
# in one of _QUIET
_CASES = {
    # budget 50 ms snaps to the 100 ms bound: 40 % bad at target 0.99
    "burn-fires": (dict(slo_ttft_budget_us=50000),
                   dict(rates=_hist_rates("serving.ttft_us",
                                          [10, 20, 30, 0, 40, 0]))),
    "burn-under-min-samples": ({}, dict(rates=_hist_rates(
        "serving.ttft_us", [0, 0, 0, 0, 0, 2]))),
    "burn-quiet": ({}, dict(rates=_hist_rates("serving.ttft_us",
                                               [50, 0, 0, 0, 0, 0]))),
    # 150000 lies between bounds: it snaps UP to 250000, so 120 ms
    # observations are within budget
    "burn-snaps-up": (dict(slo_ttft_budget_us=150000),
                      dict(rates=_hist_rates("serving.ttft_us",
                                             [0, 0, 0, 10, 0, 0]))),
    "burn-snaps-up-bad": (dict(slo_ttft_budget_us=150000),
                          dict(rates=_hist_rates("serving.ttft_us",
                                                 [0, 0, 0, 10, 5, 1]))),
    # above every finite bound the budget snaps to +inf: all good
    "burn-budget-inf": (dict(slo_ttft_budget_us=5000000),
                        dict(rates=_hist_rates("serving.ttft_us",
                                               [0, 0, 0, 0, 0, 9]))),
    # at a finite cutoff, +inf observations are bad
    "burn-inf-bucket-bad": (dict(slo_ttft_budget_us=1000000),
                            dict(rates=_hist_rates("serving.ttft_us",
                                                   [5, 0, 0, 0, 0, 5]))),
    # 40 % bad against a 50 % budget: burn 0.8, at threshold 0.7
    "burn-threshold": (dict(slo_target=0.5, alert_burn_threshold=0.7),
                       dict(rates=_hist_rates("serving.itl_us",
                                              [6, 0, 0, 0, 0, 4],
                                              dt=2.0), dt=2.0)),
    "burn-threshold-no": (dict(slo_target=0.5,
                                  alert_burn_threshold=0.9),
                             dict(rates=_hist_rates("serving.itl_us",
                                                    [6, 0, 0, 0, 0, 4]))),
    "burn-itl": (dict(slo_itl_budget_us=10000),
                 dict(rates=_hist_rates("serving.itl_us",
                                        [3, 3, 3, 3, 3, 3]))),
    "queue-grows": (dict(alert_queue_depth=4),
                    dict(rates={"serving.queue.depth": 3.0},
                         snap={"serving.queue.depth": 9})),
    "queue-shallow": (dict(alert_queue_depth=16),
                      dict(rates={"serving.queue.depth": 3.0},
                           snap={"serving.queue.depth": 9})),
    "queue-shrinks": ({}, dict(rates={"serving.queue.depth": -1.0},
                               snap={"serving.queue.depth": 30})),
    "stall": ({}, dict(rates={"serving.steps": 5.0,
                              "serving.decoded_tokens": 0.0},
                       snap={"serving.slots.running": 2})),
    "stall-idle": ({}, dict(rates={"serving.steps": 0.0},
                            snap={"serving.slots.running": 2})),
    "stall-progress": ({}, dict(rates={"serving.steps": 5.0,
                                       "serving.decoded_tokens": 40.0},
                                snap={"serving.slots.running": 2})),
    "stall-zero-window": ({}, dict(rates={"serving.steps": 5.0},
                                   snap={"serving.slots.running": 2},
                                   dt=0.0)),
    "shed": ({}, dict(rates={"serving.shed": 0.25})),
    "no-shed": ({}, dict(rates={"serving.shed": 0.0})),
}


_QUIET = ("quiet", "min-samples", "up", "inf", "threshold-no", "shallow",
          "shrinks", "idle", "progress", "window", "no-shed")


@pytest.mark.parametrize("case", sorted(_CASES))
def test_every_rule_matches_on_the_same_window(both_flags, case):
    flags, kw = _CASES[case]
    both_flags(**flags)
    ctx = _ctx(**kw)
    jrules = jalerts.default_rules()
    trules = alerts.default_rules()
    assert [(r.name, r.severity) for r in trules] == \
        [(r.name, r.severity) for r in jrules]
    fired = 0
    for jr, tr in zip(jrules, trules):
        got, want = tr.evaluate(ctx), jr.evaluate(ctx)
        assert got == want, (case, tr.name, got, want)
        fired += got[0]
        if got[0] and "trace_id" in got[1] and got[1]["trace_id"]:
            # the worst RECENT exemplar, never the stale one
            assert got[1]["trace_id"] != "t-old"
    assert bool(fired) == (not case.endswith(_QUIET)), case


def _quiet_window(mgr):
    """Consume whatever window is pending so the next evaluation sees
    only what the test does."""
    mgr.evaluate()
    time.sleep(0.01)
    mgr.evaluate()


def test_manager_edge_trigger_resolve_and_refire():
    mgr = alerts.AlertManager()
    g_run = metrics.gauge("serving.slots.running")
    c_steps = metrics.counter("serving.steps")
    c_dec = metrics.counter("serving.decoded_tokens")
    prev = g_run.value
    fired0 = metrics.counter("alerts.fired").value
    try:
        g_run.set(1)
        _quiet_window(mgr)
        c_steps.inc()
        time.sleep(0.01)
        first = mgr.evaluate()
        assert [i["rule"] for i in first] == ["decode.stall"]
        inc = first[0]
        assert inc["severity"] == "page" and inc["count"] == 1
        c_steps.inc()
        time.sleep(0.01)
        assert mgr.evaluate() == []          # the episode goes on
        assert mgr.active()[0]["count"] == 2
        c_dec.inc(5)
        c_steps.inc()
        time.sleep(0.01)
        mgr.evaluate()                       # progress: resolved
        assert mgr.active() == []
        hist = mgr.history()
        assert len(hist) == 1 and "resolved" in hist[0]
        c_steps.inc()
        time.sleep(0.01)
        assert [i["rule"] for i in mgr.evaluate()] == ["decode.stall"]
        assert metrics.counter("alerts.fired").value == fired0 + 2
        body = mgr.as_dict()
        assert {r["name"] for r in body["rules"]} == {
            "slo.ttft_burn", "slo.itl_burn", "queue.growth",
            "decode.stall", "shed.rate"}
        json.dumps(body)
    finally:
        g_run.set(prev)
        time.sleep(0.01)
        mgr.evaluate()


def test_one_flight_record_per_episode():
    mgr = alerts.AlertManager()
    g_run = metrics.gauge("serving.slots.running")
    prev = g_run.value

    def records():
        return [r for r in watchdog.flight_recorder().records()
                if r["tag"] == "alert.decode.stall"]
    try:
        g_run.set(1)
        _quiet_window(mgr)
        n0 = len(records())
        for _ in range(3):  # one episode over three windows
            metrics.counter("serving.steps").inc()
            time.sleep(0.01)
            mgr.evaluate()
        recs = records()
        assert len(recs) == n0 + 1
        assert recs[-1]["status"] == "alert"
        assert recs[-1]["severity"] == "page"
    finally:
        g_run.set(prev)
        time.sleep(0.01)
        mgr.evaluate()


def test_maybe_evaluate_rate_limited(both_flags):
    mgr = alerts.AlertManager()
    mgr.evaluate()
    both_flags(alert_interval_s=3600.0)
    before = mgr._last
    assert mgr.maybe_evaluate() == []
    assert mgr._last == before
    mgr.evaluate()
    mid = mgr._last
    assert mgr.evaluate(min_interval=3600.0) == []
    assert mgr._last == mid
    both_flags(alert_interval_s=0.0)
    mgr.maybe_evaluate()
    assert mgr._last > mid


def test_a_broken_rule_never_breaks_evaluation():
    class Broken(alerts.AlertRule):
        name = "broken"

        def evaluate(self, ctx):
            raise RuntimeError("boom")

    mgr = alerts.AlertManager(rules=[Broken()])
    errs = metrics.counter("alerts.rule_errors").value
    metrics.counter("serving.steps").inc()
    mgr.evaluate()
    metrics.counter("serving.steps").inc()
    time.sleep(0.01)
    assert mgr.evaluate() == []
    assert metrics.counter("alerts.rule_errors").value == errs + 1


# -- the scheduler's nudge and the endpoint --------------------------------

@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_params_from_numpy(named, JaxConfig.tiny()))
    return tm


def _prompt(seed, n=5):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int64)


def _engine(model, **kw):
    return ServingEngine(model, max_batch=1, block_size=8, max_seq_len=64,
                         dtype=torch.float32, background=False, **kw)


def test_scheduler_nudges_at_every_step(model, both_flags):
    """Armed: every step boundary nudges ``maybe_evaluate`` (interval 0:
    each step is a window); a long interval: one priming evaluation, then
    none. Disarmed accounting holds no manager."""
    evals = metrics.counter("alerts.evaluations")
    both_flags(alert_interval_s=0.0)
    eng = _engine(model, accounting=True)
    try:
        assert eng.alerts is eng.scheduler.alerts
        assert isinstance(eng.alerts, alerts.AlertManager)
        e0 = evals.value
        eng.submit(_prompt(1), max_new_tokens=3)
        steps = 0
        while eng.scheduler.has_work:
            eng.step()
            steps += 1
        assert evals.value - e0 == steps
        both_flags(alert_interval_s=3600.0)
        e1 = evals.value
        eng.submit(_prompt(2), max_new_tokens=3)
        eng.run_until_idle()
        assert evals.value == e1
    finally:
        eng.close()
    off = _engine(model, accounting=False)
    assert off.alerts is None
    off.close()


def test_concurrent_scrapers_share_one_evaluation(model, both_flags):
    eng = _engine(model)
    eng.submit(_prompt(11), max_new_tokens=3)
    eng.run_until_idle()
    srv = eng.serve_metrics()
    both_flags(alert_interval_s=3600.0)
    try:
        eng.alerts.evaluate()
        before = metrics.counter("alerts.evaluations").value
        errs = []

        def scraper():
            try:
                for _ in range(5):
                    urllib.request.urlopen(srv.url("/alerts"),
                                           timeout=10).read()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=scraper) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs
        assert metrics.counter("alerts.evaluations").value == before
    finally:
        eng.close()


def test_alerts_endpoint(model):
    eng = _engine(model)
    try:
        eng.submit(_prompt(7), max_new_tokens=3)
        eng.run_until_idle()
        srv = eng.serve_metrics()
        assert eng.serve_metrics() is srv  # idempotent
        body = json.loads(urllib.request.urlopen(srv.url("/alerts"),
                                                 timeout=10).read())
        assert body["attached"] is True
        assert set(body) >= {"active", "history", "rules", "window_s"}
        assert len(body["rules"]) == 5
    finally:
        eng.close()
    assert eng._metrics_server is None
