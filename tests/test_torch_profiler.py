"""PyTorch port: the profiler package (``profiler/__init__.py``)
against the JAX package on the CPU.

- ``make_scheduler`` gives the same state over steps 0-20 for several
  settings, and the ``(skip, stop)`` tuple the same windows.
- Each summary view (``_slow_requests_view``, ``_capacity_view`` with its
  gate on armed accounting, ``_goodput_view``, ``_overload_view``,
  ``_cold_start_view``) renders the JAX package's lines for the same
  snapshot dict; the scorecard view renders nothing; the incidents view
  shows flight records.
- ``RecordEvent`` spans and the hooked ops' ``Operator`` spans land in a
  recording window and in its Chrome export (no device trace on the CPU);
  ``summary()`` tabulates them.
"""

import json
import os

import pytest
import torch

from paddle_tpu import profiler as jprof
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.nn import functional as F


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2),
    dict(closed=0, ready=0, record=3, skip_first=2),
    dict(closed=2, ready=0, record=1, repeat=2),
    dict(closed=1, ready=2, record=3, repeat=1, skip_first=1),
])
def test_make_scheduler_matches(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i).name for i in range(21)] == [js(i).name
                                              for i in range(21)]


def test_tuple_scheduler_windows_match():
    jp = jprof.Profiler(scheduler=(1, 3), timer_only=True)
    tp = tprof.Profiler(scheduler=(1, 3), timer_only=True)
    assert [tp._scheduler(i).name for i in range(21)] == \
        [jp._scheduler(i).name for i in range(21)]


_SNAPS = {
    "capacity-disarmed": {"serving.steps": 5},
    "capacity-no-serving": {"accounting.steps": 5},
    "capacity": {"serving.steps": 5, "accounting.steps": 5,
                 "serving.kv.active_blocks": 3,
                 "serving.kv.free_blocks": 10,
                 "serving.kv.cached_blocks": 1,
                 "serving.kv.shared_blocks": 2,
                 "serving.kv.pool_bytes": 3 << 30,
                 "memory.live_bytes": 123456789,
                 "memory.live_arrays": 17,
                 'serving.kv.active_blocks{slice="1"}': 2,
                 'serving.kv.free_blocks{slice="1"}': 4},
    "goodput": {"accounting.device_us": 2.5e6,
                "accounting.tokens_emitted": 900,
                "accounting.goodput_tokens": 850,
                "accounting.tokens_processed": 4096,
                "accounting.attributed_us": 2.4e6,
                "accounting.compile_us": 1e5,
                "accounting.reprefill_us": 2e4,
                "accounting.idle_us": 3e3, "accounting.mfu": 0.123},
    "goodput-empty": {"accounting.device_us": 0},
    "overload": {"serving.shed": 4, "serving.admission.rejected": 2,
                 "serving.brownout.stage": 2,
                 "serving.brownout.transitions": 3,
                 "serving.brownout.clamped": 5,
                 "admission.predicted_ttft_us": {
                     "count": 7, "p50": 1200.0, "p95": 9000.0},
                 "router.breaker.opened": 1,
                 "router.breaker.closed": 1,
                 "router.breaker.skipped": 6},
    "overload-quiet": {"serving.shed": 0},
    "cold-start": {"jit.aot.hits": 3, "jit.aot.misses": 1,
                   "jit.aot.stores": 1, "jit.aot.saved_us": 2.5e6,
                   "jit.aot.bytes": 5 << 20, "jit.aot.quarantined": 1,
                   "jit.aot.load_us": {"count": 3, "p50": 900.0,
                                       "p95": 1500.0},
                   "xla.compile.seconds": {"sum": 1.25},
                   "xla.compile.count": 4},
    "cold-start-none": {},
    "slow": {"serving.ttft_us": {"exemplars": {
        "1000": {"value": 900.0, "trace_id": "t14-unknown-a"},
        "+inf": {"value": 4e6, "trace_id": "t14-unknown-b"}}},
        "serving.itl_us": {"exemplars": {
            "100": {"value": 77.5, "trace_id": "t14-unknown-c"}}},
        "serving.queue_wait_us": {"count": 0}},
}
_VIEWS = {"capacity": "_capacity_view", "goodput": "_goodput_view",
          "overload": "_overload_view", "cold-start": "_cold_start_view",
          "slow": "_slow_requests_view"}


@pytest.mark.parametrize("case", sorted(_SNAPS))
def test_summary_views_match(case):
    view = _VIEWS[next(k for k in _VIEWS if case.startswith(k))]
    snap = _SNAPS[case]
    got = getattr(tprof, view)(snap)
    assert got == getattr(jprof, view)(snap)
    quiet = case.endswith(("disarmed", "no-serving", "empty", "quiet",
                           "none"))
    assert (got == []) == quiet


def test_scorecard_view_is_empty_and_incidents_show_records():
    assert tprof._scorecard_view() == []
    watchdog.record_event("alert.t14.rule", meta={"detail": "t14 probe",
                                                  "value": 3},
                          status="alert")
    lines = tprof._recent_incidents_view()
    assert any("alert.t14.rule" in ln and "t14 probe" in ln
               for ln in lines)
    assert "Recent incidents" in lines[1]


def test_record_event_and_op_spans_in_the_chrome_export(tmp_path):
    """scheduler (1, 3): step 0 closed, steps 1-2 one window, exported at
    the step after; then step 3 opens a second window that ``stop``
    exports."""
    out = str(tmp_path / "traces")
    x = torch.randn(4, 8)
    w = torch.randn(6, 8)
    prof = tprof.Profiler(scheduler=(1, 3), record_shapes=True,
                          on_trace_ready=tprof.export_chrome_tracing(
                              out, worker_name="w"))
    with prof:
        for step in range(4):
            with tprof.RecordEvent(f"step{step}"):
                F.linear(x, w)
            prof.step()
    files = sorted(os.listdir(out))
    assert files == ["w_t0.json", "w_t1.json"]
    first = tprof.load_profiler_result(os.path.join(out, files[0]))
    names = [e["name"] for e in first["traceEvents"]]
    assert "step1" in names and "step2" in names and "step0" not in names
    ops = [e for e in first["traceEvents"] if e["cat"] == "Operator"]
    assert [e["name"] for e in ops] == ["linear", "linear"]
    assert ops[0]["args"]["shapes"] == [[4, 6]]
    assert ops[0]["args"]["path"] == "eager"
    assert first["device_trace"] is None  # no GPU here
    assert "metrics" in first
    table = prof.summary()
    assert "linear" in table and "step3" in table
    # the hook is disarmed again once the window closed
    from paddle_tpu_torch.core import dispatch
    assert not dispatch.HOOKS.armed


def test_profile_memory_takes_no_sample_without_a_gpu(tmp_path):
    prof = tprof.Profiler(profile_memory=True, timer_only=True)
    with prof:
        prof.step()
    assert prof._memory_samples == []
    with pytest.raises(NotImplementedError, match="protobuf"):
        tprof.load_profiler_result(str(tmp_path / "x.pb"))
