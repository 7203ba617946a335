"""The profiler (mirrors ``paddle_tpu/profiler/__init__.py``).

- ``Profiler`` (``start`` / ``stop`` / ``step``, a ``make_scheduler``
  state machine CLOSED -> READY -> RECORD -> RECORD_AND_RETURN, or a
  ``(skip, stop)`` tuple), ``RecordEvent`` host spans, Chrome-trace
  export (``export_chrome_tracing``) and ``summary()``.
- Host events come from ``RecordEvent`` and from the functional ops'
  post hook (``core/dispatch.py``: one ``Operator`` span a hooked op,
  with shapes and dtypes under ``record_shapes``).
- The device trace: the JAX package runs ``jax.profiler`` into an
  xplane directory; here a recording window on a CUDA machine runs
  ``torch.profiler`` with CPU and CUDA activity, exported beside the host
  trace as ``<name>_t<n>.device.json`` (the host trace names it under
  ``device_trace``). None on a CPU run or with ``timer_only``.
- ``profile_memory=True`` samples ``torch.cuda.memory_allocated`` (and
  the peak, and the count of live allocation blocks) at step boundaries
  while recording, under the JAX package's gauge names
  (``memory.live_bytes``, ``memory.live_arrays``). Nothing on a CPU run.
- ``summary_text()``: the registry-driven sections (Serving / SLO View,
  Slow requests, Capacity View, Goodput, Overload, Cold start, Recent
  incidents), each a function of a snapshot dict; ``MetricsServer``'s
  ``/summary`` serves it. The cold-start view renders nothing without
  ``jit.aot.*`` counters, which the port never sets (it has no AOT
  cache), and the scenario-scorecard view nothing until
  ``profiler/scorecard.py`` is ported.

Not ported: ``export_protobuf`` and its ``.pb`` format.
"""

from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing",
           "load_profiler_result", "SortedKeys", "SummaryView", "metrics",
           "tracing", "export", "accounting", "alerts", "summary_text"]


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class _HostEventRecorder:
    """Host span store. ``enabled`` and ``record_shapes`` follow the
    recording Profiler; the op post hook (``core/dispatch.py``) reads
    them, and is re-armed whenever they change (``_set``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events = []
        self.enabled = False
        self.record_shapes = False

    def _set(self, enabled, record_shapes=False):
        from ..core import dispatch
        self.enabled = enabled
        self.record_shapes = record_shapes
        dispatch.HOOKS.recorder = self if enabled else None
        dispatch.refresh()

    def record(self, name, start, end, event_type="UserDefined",
               args=None):
        if not self.enabled:
            return
        ev = {"name": name, "ts": start, "dur": end - start,
              "tid": threading.get_ident(), "type": event_type}
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def drain(self):
        with self._lock:
            ev, self.events = self.events, []
        return ev


_recorder = _HostEventRecorder()

# the always-on registry, request tracing and the export surface; cost
# accounting and the SLO alert rules (the serving scheduler drives them,
# the summary renders their views)
from . import metrics, tracing  # noqa: E402
from . import export  # noqa: E402
from . import accounting, alerts  # noqa: E402


class RecordEvent:
    """Context-manager host span (the reference's event_tracing.h:32)."""

    def __init__(self, name, event_type="UserDefined"):
        self.name = name
        self.event_type = event_type
        self._begin = None

    def begin(self):
        self._begin = time.perf_counter_ns() / 1000.0

    def end(self):
        if self._begin is not None:
            _recorder.record(self.name, self._begin,
                             time.perf_counter_ns() / 1000.0,
                             self.event_type)
            self._begin = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """The state of each step: ``skip_first`` CLOSED steps, then cycles
    of ``closed`` CLOSED, ``ready`` READY and ``record`` recording steps
    (the last RECORD_AND_RETURN), ``repeat`` times (0: forever)."""
    total = closed + ready + record

    def scheduler(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_on_trace_ready(prof):
    pass


def export_chrome_tracing(dir_name, worker_name=None):
    """``on_trace_ready`` handler: each recording window's host trace to
    ``<dir_name>/<worker>_t<n>.json`` (and its device trace beside it)."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(dir_name,
                            f"{name}_t{prof._export_count}.json")
        prof._export_chrome(path)

    return handler


def load_profiler_result(path):
    """Load an exported Chrome trace (.json)."""
    if path.endswith(".pb"):
        raise NotImplementedError(
            "the protobuf trace format (export_protobuf) is not ported; "
            "export_chrome_tracing writes .json")
    with open(path) as f:
        return json.load(f)


def _slow_requests_view(serving_snap):
    """"Slow requests" summary section: the per-bucket max-latency
    exemplars of the serving SLO histograms (docs/OBSERVABILITY.md),
    worst first — each row names the trace_id to pull from the ring
    (``tracing.export_trace`` / the /traces/<id> endpoint). ``spans``
    says how much of that trace is still exportable."""
    rows = []
    for name in ("serving.ttft_us", "serving.itl_us",
                 "serving.queue_wait_us"):
        v = serving_snap.get(name)
        if isinstance(v, dict):
            for ex in (v.get("exemplars") or {}).values():
                rows.append((ex["value"], name, ex["trace_id"]))
    if not rows:
        return []
    rows.sort(reverse=True)
    lines = ["", "{:-^72}".format(" Slow requests (exemplars) "),
             "{:<24} {:>14}  {:<18} {}".format(
                 "metric", "latency_us", "trace_id", "spans")]
    for value, name, tid in rows[:8]:
        lines.append("{:<24} {:>14.1f}  {:<18} {}".format(
            name, value, tid, len(tracing.get_trace(tid))))
    return lines


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


def _capacity_view(snap):
    """"Capacity View" summary section: the KV-pool occupancy breakdown
    (active / shared / cached-free / free blocks, pool bytes) plus the
    live device memory sample: the headroom admission and eviction
    decisions are made against (profiler/accounting.py)."""
    # gate on ARMED accounting having stepped, not mere gauge
    # registration — a disarmed serving run (FLAGS_serving_accounting=0)
    # never sets these gauges and must not render a bogus zero pool
    if not snap.get("serving.steps") or not snap.get("accounting.steps"):
        return []
    active = snap.get("serving.kv.active_blocks", 0)
    shared = snap.get("serving.kv.shared_blocks", 0)
    cached = snap.get("serving.kv.cached_blocks", 0)
    free = snap.get("serving.kv.free_blocks", 0)
    usable = active + cached + free
    lines = ["", "{:-^72}".format(" Capacity View (KV pool / HBM) "),
             "{:<26} {:>10} {}".format("resource", "value", "notes")]
    rows = [
        ("kv.active_blocks", active, "pinned by live requests"),
        ("kv.shared_blocks", shared, "backing >1 slot (prefix cache)"),
        ("kv.cached_free_blocks", cached, "reclaimable (LRU-evictable)"),
        ("kv.free_blocks", free, "truly free"),
        ("kv.usable_blocks", usable,
         f"occupancy {active / usable:.1%}" if usable else ""),
    ]
    pool_b = snap.get("serving.kv.pool_bytes", 0)
    if pool_b:
        rows.append(("kv.pool_bytes", _fmt_bytes(pool_b),
                     "static K+V pool footprint"))
    live_b = snap.get("memory.live_bytes", 0)
    if live_b:
        rows.append(("hbm.live_bytes", _fmt_bytes(live_b),
                     f"{snap.get('memory.live_arrays', 0)} live arrays"))
    for name, value, note in rows:
        lines.append("{:<26} {:>10} {}".format(name, value, note))
    # mesh-sharded serving: the per-slice breakdown rides slice-labeled
    # gauges (serving.kv.*{slice="i"}); absent on one device
    slices = {}
    for key, v in snap.items():
        if key.startswith("serving.kv.") and '{slice="' in key:
            base, _, lab = key.partition("{")
            sid = lab.split('"')[1]
            slices.setdefault(sid, {})[base.rsplit(".", 1)[-1]] = v
    for sid in sorted(slices, key=lambda s: (len(s), s)):
        d = slices[sid]
        lines.append(
            "{:<26} {:>10} {}".format(
                f"kv.slice[{sid}]",
                d.get("active_blocks", 0),
                f"active (free {d.get('free_blocks', 0)}, shared "
                f"{d.get('shared_blocks', 0)}, cached "
                f"{d.get('cached_blocks', 0)})"))
    return lines


def _goodput_view(snap):
    """"Goodput" summary section: engine-level cost attribution rollup
    — deadline-met tokens per attributed device-second, raw tokens/s,
    MFU estimate, and where non-serving time went (compile, preemption
    re-prefill waste, idle steps)."""
    device_us = snap.get("accounting.device_us", 0)
    if not device_us:
        return []
    device_s = device_us / 1e6
    tokens = snap.get("accounting.tokens_emitted", 0)
    good = snap.get("accounting.goodput_tokens", 0)
    lines = ["", "{:-^72}".format(" Goodput (cost attribution) "),
             "{:<30} {}".format("metric", "value")]
    rows = [
        ("goodput tokens/device-s", f"{good / device_s:.1f}"),
        ("raw tokens/device-s", f"{tokens / device_s:.1f}"),
        ("deadline-met tokens", f"{good} / {tokens} emitted"),
        ("processed tokens (padded)",
         f"{snap.get('accounting.tokens_processed', 0)}"),
        ("device seconds", f"{device_s:.3f}"),
        ("attributed_us", f"{snap.get('accounting.attributed_us', 0):.0f}"),
        ("compile_us (billed direct)",
         f"{snap.get('accounting.compile_us', 0):.0f}"),
        ("reprefill_us (preempt waste)",
         f"{snap.get('accounting.reprefill_us', 0):.0f}"),
        ("idle_us (empty steps)",
         f"{snap.get('accounting.idle_us', 0):.0f}"),
    ]
    mfu = snap.get("accounting.mfu", 0)
    if mfu:
        rows.insert(2, ("mfu estimate", f"{mfu:.3f}"))
    for name, value in rows:
        lines.append("{:<30} {}".format(name, value))
    return lines


def _overload_view(snap):
    """"Overload" summary section: the admission/shed/brownout control
    plane (serving/overload.py) plus the router's per-replica circuit
    breakers — what the engine refused, dropped, or degraded to keep
    the surviving traffic inside its SLOs. Renders only once any of it
    acted (armed runs under pressure); a disarmed or uncontended
    process shows nothing."""
    shed = snap.get("serving.shed", 0)
    rejected = snap.get("serving.admission.rejected", 0)
    stage = snap.get("serving.brownout.stage", 0)
    transitions = snap.get("serving.brownout.transitions", 0)
    clamped = snap.get("serving.brownout.clamped", 0)
    opened = snap.get("router.breaker.opened", 0)
    skipped = snap.get("router.breaker.skipped", 0)
    if not (shed or rejected or stage or transitions or clamped
            or opened):
        return []
    lines = ["",
             "{:-^72}".format(" Overload (admission / shed / brownout) "),
             "{:<30} {}".format("metric", "value")]
    rows = [
        ("brownout stage", f"{stage} (transitions {transitions})"),
        ("shed requests", f"{shed}"),
        ("admission rejected", f"{rejected}"),
        ("max_new_tokens clamped", f"{clamped}"),
    ]
    pred = snap.get("admission.predicted_ttft_us")
    if isinstance(pred, dict) and pred.get("count"):
        rows.append(("predicted TTFT p50/p95",
                     f"{pred['p50']:.0f}us / {pred['p95']:.0f}us "
                     f"({pred['count']} predictions)"))
    if opened or skipped:
        rows.append(("breaker opened / closed",
                     f"{opened} / "
                     f"{snap.get('router.breaker.closed', 0)}"))
        rows.append(("breaker short-circuits", f"{skipped}"))
    for name, value in rows:
        lines.append("{:<30} {}".format(name, value))
    return lines


def _cold_start_view(snap):
    """"Cold start" summary section: the JAX package's persistent AOT
    compile cache (hits, misses, stores, bytes, load latency, compile
    seconds saved). Renders only once ``jit.aot.*`` counters moved; the
    port has no AOT cache, so it renders nothing there, as a disarmed JAX
    process does."""
    hits = snap.get("jit.aot.hits", 0)
    misses = snap.get("jit.aot.misses", 0)
    stores = snap.get("jit.aot.stores", 0)
    if not (hits or misses or stores):
        return []
    lines = ["", "{:-^72}".format(" Cold start (AOT compile cache) "),
             "{:<30} {}".format("metric", "value")]
    rows = [
        ("aot hits / misses", f"{hits} / {misses}"),
        ("aot stores", f"{stores}"),
        ("compile seconds saved",
         f"{snap.get('jit.aot.saved_us', 0) / 1e6:.3f}s"),
        ("payload bytes moved",
         _fmt_bytes(snap.get("jit.aot.bytes", 0))),
    ]
    q = snap.get("jit.aot.quarantined", 0)
    if q:
        rows.append(("entries quarantined", f"{q} (see *.corrupt-N)"))
    load = snap.get("jit.aot.load_us")
    if isinstance(load, dict) and load.get("count"):
        rows.append(("load latency p50/p95",
                     f"{load['p50']:.0f}us / {load['p95']:.0f}us"))
    comp = snap.get("xla.compile.seconds")
    if isinstance(comp, dict):
        rows.append(("xla compiles this process",
                     f"{snap.get('xla.compile.count', 0)} "
                     f"({comp.get('sum', 0.0):.3f}s)"))
    for name, value in rows:
        lines.append("{:<30} {}".format(name, value))
    return lines


def _scorecard_view():
    """"Scenario scorecard" summary section: empty until
    ``profiler/scorecard.py`` is ported; kept so the sections keep their
    order."""
    return []


def summary_text():
    """The registry-driven half of ``Profiler.summary``: the serving/SLO
    table and every always-on section (capacity, goodput, overload, cold
    start, scenario scorecard, incidents), without a Profiler or op
    events. ``MetricsServer``'s ``/summary`` serves it."""
    lines = []
    serving = metrics.snapshot("serving.")
    if serving and serving.get("serving.steps"):
        lines.append("{:-^72}".format(" Serving / SLO View "))
        lines.append("{:<36} {}".format("metric", "value"))
        for name in sorted(serving):
            v = serving[name]
            if isinstance(v, dict):
                desc = f"count={v['count']}"
                if v["count"]:
                    desc += (f" avg={v['avg']:.6g} min={v['min']:.6g}"
                             f" max={v['max']:.6g} p50={v['p50']:.6g}"
                             f" p95={v['p95']:.6g} p99={v['p99']:.6g}")
            else:
                desc = str(v)
            lines.append("{:<36} {}".format(name, desc))
        lines.extend(_slow_requests_view(serving))
    full_snap = metrics.snapshot()
    lines.extend(_capacity_view(full_snap))
    lines.extend(_goodput_view(full_snap))
    lines.extend(_overload_view(full_snap))
    lines.extend(_cold_start_view(full_snap))
    lines.extend(_scorecard_view())
    lines.extend(_recent_incidents_view())
    return "\n".join(lines)


def _recent_incidents_view(limit=10):
    """"Recent incidents" summary section: the flight-recorder ring
    (``distributed/watchdog.py``: degradations from
    ``core.resilience.degrade``, alert incidents)."""
    try:
        from ..distributed import watchdog
    except Exception:  # noqa: BLE001 - summary must render regardless
        return []
    recs = [r for r in watchdog.flight_recorder().records()
            if r.get("status") not in ("done", "running")]
    if not recs:
        return []
    now = time.time()
    lines = ["", "{:-^72}".format(" Recent incidents (flight ring) "),
             "{:<5} {:>8} {:<28} {:<10} {}".format(
                 "seq", "age_s", "event", "status", "detail")]
    for r in recs[-limit:]:
        meta = {k: v for k, v in r.items()
                if k not in ("seq", "tag", "start", "end", "status")}
        detail = meta.pop("detail", "")
        if meta:
            detail = (detail + " " + json.dumps(meta, default=str)).strip()
        lines.append("{:<5} {:>8.1f} {:<28} {:<10} {}".format(
            r["seq"], now - r["start"], r["tag"][:28], r["status"],
            detail[:60]))
    return lines


class Profiler:
    """The reference's profiler.py:346: ``scheduler`` is a callable
    (step -> ``ProfilerState``), a ``(skip, stop)`` tuple (record steps
    skip .. stop - 1) or None (record from ``start`` on);
    ``on_trace_ready(prof)`` runs at the end of each recording window."""

    def __init__(self, *, targets=None, scheduler=None, on_trace_ready=None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        self._scheduler = scheduler if callable(scheduler) else (
            make_scheduler(closed=0, ready=0,
                           record=(scheduler[1] - scheduler[0]),
                           skip_first=scheduler[0])
            if isinstance(scheduler, (tuple, list)) else
            (lambda step: ProfilerState.RECORD))
        self._on_trace_ready = on_trace_ready or _default_on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._events = []
        self._memory_samples = []
        self._export_count = 0
        self._device_prof = None     # torch.profiler of the window
        self._window_prof = None     # ... once stopped, until exported
        self._device_trace = None    # its exported file
        self._step_begin = None
        self._step_info = ""

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._transition(self._scheduler(self.step_num))

    def stop(self):
        if self._state in _RECORDING:
            self._window_done()
        self._transition(ProfilerState.CLOSED)

    def step(self, num_samples=None):
        if self._step_begin is not None:
            dur = time.perf_counter() - self._step_begin
            if num_samples:
                self._step_info = (
                    f"ips: {num_samples / dur:.3f} samples/s")
        self._step_begin = time.perf_counter()
        self._maybe_sample_memory()
        prev = self._state
        if prev == ProfilerState.RECORD_AND_RETURN:
            self._window_done()
        self.step_num += 1
        new = self._scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN and new in _RECORDING:
            self._maybe_start_device_trace()  # the next window's
        self._transition(new)

    def step_info(self, unit=None):
        return self._step_info

    def _window_done(self):
        """End of a recording window: the device trace stops (torch's
        profiler exports only once stopped), host events are collected
        and ``on_trace_ready`` runs."""
        self._maybe_stop_device_trace()
        self._collect()
        self._on_trace_ready(self)

    def _transition(self, new):
        if new == self._state:
            return
        if new in _RECORDING and self._state not in _RECORDING:
            _recorder._set(True, self._record_shapes)
            self._maybe_sample_memory()
            self._maybe_start_device_trace()
        if new not in _RECORDING and self._state in _RECORDING:
            self._maybe_sample_memory()
            _recorder._set(False)
            self._maybe_stop_device_trace()
        self._state = new

    def _maybe_sample_memory(self):
        """profile_memory=True: sample the card's allocated bytes (and
        the peak, and the live allocation blocks) at step boundaries
        while recording; nothing without a GPU."""
        if not self._profile_memory or not _recorder.enabled:
            return
        import torch
        if not torch.cuda.is_available():
            return
        live = int(torch.cuda.memory_allocated())
        blocks = int(torch.cuda.memory_stats().get("active.all.current",
                                                   0))
        sample = {"ts": time.perf_counter_ns() / 1000.0,
                  "step": self.step_num, "live_arrays": blocks,
                  "live_bytes": live, "device_bytes_in_use": live,
                  "device_peak_bytes": int(
                      torch.cuda.max_memory_allocated()),
                  "device": f"cuda:{torch.cuda.current_device()}"}
        self._memory_samples.append(sample)
        metrics.gauge("memory.live_bytes").set(live)
        metrics.gauge("memory.live_arrays").set(blocks)

    def _maybe_start_device_trace(self):
        import torch
        if self._timer_only or self._device_prof is not None or \
                not torch.cuda.is_available():
            return
        from torch.profiler import ProfilerActivity, profile
        self._device_prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=self._record_shapes,
            profile_memory=self._profile_memory)
        self._device_prof.__enter__()

    def _maybe_stop_device_trace(self):
        if self._device_prof is not None:
            import torch
            torch.cuda.synchronize()
            self._device_prof.__exit__(None, None, None)
            self._window_prof, self._device_prof = self._device_prof, None

    def _collect(self):
        self._events.extend(_recorder.drain())

    # -- export / summary --------------------------------------------------
    def _export_chrome(self, path):
        self._export_count += 1
        if self._window_prof is not None:
            self._device_trace = os.path.splitext(path)[0] + ".device.json"
            self._window_prof.export_chrome_trace(self._device_trace)
            self._window_prof = None
        trace = []
        for e in self._events:
            ce = {"name": e["name"], "ph": "X", "ts": e["ts"],
                  "dur": e["dur"], "pid": os.getpid(), "tid": e["tid"],
                  "cat": e["type"]}
            if e.get("args"):
                ce["args"] = e["args"]
            trace.append(ce)
        pid = os.getpid()
        for s in self._memory_samples:
            # chrome counter events: live memory renders as a graph track
            trace.append({"name": "live_bytes", "ph": "C", "ts": s["ts"],
                          "pid": pid,
                          "args": {"live_bytes": s["live_bytes"]}})
        with open(path, "w") as f:
            json.dump({"traceEvents": trace,
                       "memory_samples": self._memory_samples,
                       "metrics": metrics.snapshot(),
                       "device_trace": self._device_trace}, f,
                      default=str)

    def export(self, path, format="json"):
        if format in ("pb", "protobuf") or path.endswith(".pb"):
            raise NotImplementedError(
                "the protobuf trace format is not ported; export .json")
        self._collect()
        self._export_chrome(path)

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms", views=None):
        self._collect()
        # OperatorView: per-op totals and the dispatch path of each
        agg = {}
        for e in self._events:
            a = agg.setdefault(
                e["name"], {"calls": 0, "total": 0.0, "max": 0.0,
                            "paths": {}})
            a["calls"] += 1
            a["total"] += e["dur"]
            a["max"] = max(a["max"], e["dur"])
            path = (e.get("args") or {}).get("path")
            if path:
                a["paths"][path] = a["paths"].get(path, 0) + 1
        lines = ["{:<40} {:>8} {:>12} {:>12} {:>12}  {}".format(
            "Name", "Calls", "Total(us)", "Avg(us)", "Max(us)",
            "Paths(path=calls)")]
        for name, a in sorted(agg.items(), key=lambda kv: -kv[1]["total"]):
            paths = ",".join(f"{k}={v}"
                             for k, v in sorted(a["paths"].items()))
            lines.append(
                "{:<40} {:>8} {:>12.1f} {:>12.1f} {:>12.1f}  {}".format(
                    name[:40], a["calls"], a["total"],
                    a["total"] / a["calls"], a["max"], paths))
        text = summary_text()
        if text:
            lines.append("")
            lines.append(text)
        if self._memory_samples:
            lines.append("")
            lines.append("{:-^72}".format(" Memory View "))
            lines.append("{:<8} {:>14} {:>14} {:>18} {:>12}".format(
                "Step", "LiveArrays", "LiveBytes", "DeviceInUse", "Peak"))
            for s in self._memory_samples:
                lines.append(
                    "{:<8} {:>14} {:>14} {:>18} {:>12}".format(
                        s["step"], s["live_arrays"], s["live_bytes"],
                        s.get("device_bytes_in_use", "-"),
                        s.get("device_peak_bytes", "-")))
        table = "\n".join(lines)
        print(table)
        return table

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
