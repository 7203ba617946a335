"""Thread-safe serving frontend: submit / stream / cancel over the
iteration scheduler (mirrors ``paddle_tpu/serving/frontend.py``).

``ServingEngine`` is the entry point a server loop calls from many
threads:

- ``submit() -> RequestHandle``: validated admission; the handle streams
  tokens (``stream()``, an ``on_token`` callback), waits for completion
  (``result()``) and cancels.
- a background **driver thread** (default) runs scheduler steps while
  work exists and sleeps on a condition otherwise; ``background=False``
  leaves the stepping to the caller (``step()`` / ``run_until_idle()``),
  for deterministic tests.
- per-request deadlines ride on ``core.resilience.Deadline``; an expired
  request ends ``TIMEOUT`` at the next step boundary.
- a **lifecycle** ``WARMING -> READY -> DRAINING -> CLOSED``:
  ``submit()`` is accepted only in READY. ``warmup()`` runs every
  prefill bucket (``bucket_lengths``), the batched decode step and, with
  speculation armed, the verify sweep against throwaway slots, so on the
  GPU every kernel of the path is built and first launched before live
  traffic, then flips WARMING -> READY.
  ``drain()`` stops admission (``NotReadyError``), lets every in-flight
  request finish and flips to CLOSED.
- **cost and traces**: ``RequestHandle.cost()`` is the request's
  ``profiler.accounting.CostReport`` (None with accounting disarmed),
  ``RequestHandle.trace_id`` its trace (``profiler.tracing.export_trace``
  renders it); ``ServingEngine.accounting`` is the engine's accountant
  (``engine_report()``, ``goodput_line()``).
- **telemetry**: ``ServingEngine.alerts`` is the scheduler's SLO
  ``AlertManager`` (``profiler/alerts.py``; None with accounting
  disarmed), and ``serve_metrics(port=0)`` attaches one
  ``profiler.export.MetricsServer`` on 127.0.0.1 (``/metrics``,
  ``/healthz``, ``/readyz``, ``/alerts``, ``/summary``, ``/traces``),
  closed with the engine.

One re-entrant lock guards the scheduler, and the driver holds it for a
whole scheduling iteration, so ``submit()``/``cancel()``/``tokens()`` may
wait up to one step. Grad mode is per thread; the model's serving
methods run under ``torch.inference_mode()`` on whichever thread steps.
If the driver thread dies, every live request ends ``ERROR`` and the
cause re-raises from ``submit``/``result``.

Not ported yet (ROADMAP.md §1): the fleet registry
(``serve_metrics(store=...)`` raises ``NotImplementedError``),
``submit_handoff`` and replica roles other than ``"mixed"``; the fleet
cache publisher.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time

import numpy as np

from ..core import resilience
from ..profiler import metrics as _metrics
from ..profiler import tracing as _tracing
from .bucketing import bucket_lengths
from .scheduler import (AdmissionRejected, QueueFullError, RequestStatus,
                        Scheduler)

__all__ = ["ServingEngine", "RequestHandle", "QueueFullError",
           "AdmissionRejected", "RequestStatus", "Lifecycle",
           "NotReadyError"]

_SENTINEL = object()


class Lifecycle:
    """Readiness states: WARMING rejects submits (``warmup()`` -> READY);
    READY serves; DRAINING finishes in-flight work and rejects new
    submits; CLOSED is terminal."""

    WARMING = "WARMING"
    READY = "READY"
    DRAINING = "DRAINING"
    CLOSED = "CLOSED"


class NotReadyError(RuntimeError):
    """Submission rejected because the engine is not READY (WARMING,
    DRAINING or CLOSED)."""


_c_drain_started = _metrics.counter("serving.drain.started")
_c_drain_completed = _metrics.counter("serving.drain.completed")
_c_warmup_programs = _metrics.counter("serving.warmup.programs")
_h_warmup_us = _metrics.histogram(
    "serving.warmup_us",
    bounds=(10000, 100000, 500000, 1000000, 5000000, 30000000))
_g_lifecycle_ready = _metrics.gauge("serving.lifecycle.ready")


class RequestHandle:
    """Caller-side view of one request. Safe to use from any thread."""

    def __init__(self, engine):
        self._engine = engine
        self._req = None  # bound by ServingEngine.submit
        self._q = queue_mod.Queue()
        self._done = threading.Event()

    @property
    def rid(self):
        return self._req.rid

    @property
    def status(self):
        return self._req.status

    @property
    def preempts(self):
        return self._req.preempts

    @property
    def retry_after_s(self):
        """Back-off hint in seconds when this request was load-shed
        (status ``SHED``); None otherwise or while the service-time model
        is unprimed."""
        return self._req.retry_after_s

    @property
    def trace_id(self):
        """This request's trace id (None when tracing is off or the trace
        was not sampled); ``profiler.tracing.export_trace`` renders it
        once the request is terminal."""
        return self._req.trace_id

    def tokens(self):
        """Tokens generated so far (a stable snapshot)."""
        with self._engine._lock:
            return list(self._req.generated)

    def cost(self):
        """A detached copy of this request's ``CostReport``: the step
        time attributed to it (prefill, decode, re-prefill, kernel
        builds), its queue wait and TTFT, token, prefix-coverage and
        speculation counts and, once terminal, ``deadline_met``. None
        when accounting is disarmed (``FLAGS_serving_accounting=0``)."""
        with self._engine._lock:
            c = self._req.cost
            return c.clone() if c is not None else None

    def cancel(self):
        self._engine.cancel(self)

    def stream(self, timeout=None):
        """Yield tokens as they are produced; ends when the request
        reaches a terminal status (check ``.status``). If the engine died
        the stream raises its error instead of ending. ``timeout`` bounds
        the wait per token (``queue.Empty`` past it)."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is _SENTINEL:
                if self._req.status == RequestStatus.ERROR:
                    err = self._engine._error
                    if err is not None:
                        raise err
                return
            yield item

    def result(self, timeout=None):
        """Block until terminal; returns the generated tokens. Raises
        TimeoutError past ``timeout``, or the engine's error if serving
        died."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not finished within {timeout}s")
        if self._req.status == RequestStatus.ERROR:
            err = self._engine._error
            if err is not None:
                raise err
        return self.tokens()


class ServingEngine:
    """See the module docstring. Construct once per model; usable as a
    context manager (``with ServingEngine(model) as eng: ...``)."""

    def __init__(self, model, *, max_batch=8, block_size=16,
                 max_seq_len=2048, num_blocks=None, temperature=0.0,
                 eos_token_id=None, dtype=None,
                 prefill_token_budget=None, max_queue=None,
                 bucket_cap=None, prefix_cache=None, accounting=None,
                 admission=None, brownout=None, kv_cache_dtype=None,
                 spec=None, spec_tokens=None, mesh=None, background=True,
                 ready=True, role=None, paged_kernel=None, generator=None):
        if role not in (None, "mixed"):
            raise NotImplementedError(
                f"ServingEngine: role {role!r} is not ported yet "
                "(ROADMAP.md §1, the long tail: disaggregated serving)")
        self.role = "mixed"
        self._state = Lifecycle.WARMING
        self._sched = Scheduler(
            model, max_batch=max_batch, block_size=block_size,
            max_seq_len=max_seq_len, num_blocks=num_blocks,
            temperature=temperature, eos_token_id=eos_token_id,
            dtype=dtype, prefill_token_budget=prefill_token_budget,
            max_queue=max_queue, bucket_cap=bucket_cap,
            prefix_cache=prefix_cache, accounting=accounting,
            admission=admission, brownout=brownout,
            kv_cache_dtype=kv_cache_dtype, spec=spec,
            spec_tokens=spec_tokens, mesh=mesh, paged_kernel=paged_kernel,
            generator=generator)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._background = background
        self._thread = None
        self._closed = False
        self._error = None
        self._metrics_server = None
        # ready=False holds the engine in WARMING: submit() raises
        # NotReadyError until warmup() (or mark_ready()) flips READY
        if ready:
            self._state = Lifecycle.READY
        _g_lifecycle_ready.set(1 if ready else 0)

    # -- submission ----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=32, *, deadline_s=None,
               deadline=None, priority=None, on_token=None):
        """Enqueue a request; returns a RequestHandle at once.

        ``deadline_s`` (relative seconds) or ``deadline`` (a
        ``resilience.Deadline``) bounds total latency: expiry ends the
        request ``TIMEOUT`` at the next step boundary, and with the
        overload control armed a deadline the service-time model proves
        unmeetable raises ``AdmissionRejected`` here. ``priority`` is an
        int class (smaller = more important). ``on_token(token)`` runs
        per token on the stepping thread; keep it fast."""
        handle = RequestHandle(self)

        def _sink_token(req, tok):
            handle._q.put(tok)
            if on_token is not None:
                on_token(tok)

        def _sink_finish(req):
            handle._q.put(_SENTINEL)
            handle._done.set()

        with self._cond:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if self._error is not None:
                raise RuntimeError(
                    "ServingEngine died; no new submissions") \
                    from self._error
            if self._state != Lifecycle.READY:
                hint = "call warmup() first" \
                    if self._state == Lifecycle.WARMING \
                    else "route to another replica"
                raise NotReadyError(
                    f"ServingEngine is {self._state}; not accepting "
                    f"new requests ({hint})")
            if deadline is None and deadline_s is not None:
                deadline = resilience.Deadline.after(deadline_s)
            handle._req = self._sched.submit(
                prompt_ids, max_new_tokens, deadline=deadline,
                priority=priority, on_token=_sink_token,
                on_finish=_sink_finish)
            self._ensure_driver()
            self._cond.notify_all()
        return handle

    def _ensure_driver(self):
        # caller holds the lock
        if self._background and self._thread is None:
            self._thread = threading.Thread(
                target=self._drive, name="paddle-tpu-torch-serving",
                daemon=True)
            self._thread.start()

    def cancel(self, handle):
        with self._cond:
            self._sched.cancel(handle._req)
            self._cond.notify_all()

    # -- stepping ------------------------------------------------------

    @property
    def has_work(self):
        return self._sched.has_work

    @property
    def scheduler(self):
        return self._sched

    @property
    def cache(self):
        return self._sched.cache

    @property
    def accounting(self):
        """The engine's cost accountant (``profiler/accounting.py``), the
        null accountant when disarmed: ``engine_report()`` and
        ``goodput_line()`` aggregate goodput."""
        return self._sched.accounting

    @property
    def alerts(self):
        """The engine's ``AlertManager`` (None when accounting is
        disarmed); also served from the metrics endpoint's ``/alerts``."""
        return self._sched.alerts

    def step(self):
        """Run one scheduling iteration (foreground mode, or an extra
        nudge in background mode)."""
        with self._lock:
            return self._sched.step()

    def run_until_idle(self):
        """Step until the scheduler is idle (foreground mode). Results
        arrive through the handles; the lifecycle does not move."""
        while True:
            with self._lock:
                if not self._sched.has_work:
                    return
            self.step()

    # -- lifecycle -----------------------------------------------------

    @property
    def lifecycle(self):
        """The current :class:`Lifecycle` state."""
        return self._state

    def warmup(self):
        """Run every prefill bucket the configuration can produce
        (``bucket_lengths``), the batched decode step once and, with
        speculation armed, the verify sweep once, against throwaway slots
        (freed afterwards; no request exists yet), then flip WARMING ->
        READY. On the GPU this builds and first-launches every kernel of
        the path, so live traffic pays neither. Repeating it in READY
        revisits the same shapes; it raises past DRAINING. Returns the
        number of programs visited."""
        with self._lock:
            if self._state in (Lifecycle.DRAINING, Lifecycle.CLOSED):
                raise RuntimeError(
                    f"cannot warmup a {self._state} engine")
            sched = self._sched
            cache = sched.cache
            model = sched.model
            buckets = bucket_lengths(cache.block_size, sched.bucket_cap,
                                     sched.max_seq_len)
            t0 = time.perf_counter_ns()
            n = 0
            decoded = False
            with _tracing.span("serving.warmup", buckets=len(buckets)):
                for b in buckets:
                    slot = cache.alloc_slot(b)
                    if slot is None:
                        continue  # pool smaller than the ladder's tail
                    try:
                        model.paged_prefill(
                            cache, slot, np.zeros((b,), np.int64),
                            temperature=sched.temperature,
                            generator=sched.generator, pad_to=b)
                        n += 1
                        if not decoded:
                            n += self._warm_decode(slot)
                            decoded = True
                    finally:
                        cache.free_slot(slot)
            _c_warmup_programs.inc(n)
            _h_warmup_us.observe((time.perf_counter_ns() - t0) / 1000.0)
        if self._state == Lifecycle.WARMING:
            self.mark_ready()
        return n

    def _warm_decode(self, slot):
        """The decode step and, with speculation armed, the verify sweep,
        on ``slot`` (writes past its blocks land in the null block, the
        bucketing convention; the caller frees the slot). Returns the
        number of programs run."""
        sched = self._sched
        cache = sched.cache
        active = np.zeros((cache.max_batch,), bool)
        active[slot] = True
        sched.model.paged_decode_step(
            cache, np.zeros((cache.max_batch,), np.int64), active,
            temperature=sched.temperature, kernel_mode=sched.kernel_mode,
            generator=sched.generator)
        if not sched.spec:
            return 1
        k = sched.spec_tokens
        sched.model.paged_spec_step(
            cache, np.zeros((cache.max_batch,), np.int64),
            np.zeros((cache.max_batch, k), np.int64),
            np.full((cache.max_batch,), 1 + k, np.int64), active)
        return 2

    def mark_ready(self):
        """WARMING -> READY (a no-op in READY; raises past that)."""
        with self._cond:
            if self._state in (Lifecycle.DRAINING, Lifecycle.CLOSED):
                raise RuntimeError(
                    f"cannot mark_ready a {self._state} engine")
            self._state = Lifecycle.READY
            _g_lifecycle_ready.set(1)

    def drain(self, timeout=60):
        """Graceful end of admission: READY -> DRAINING (new ``submit()``
        raises :class:`NotReadyError`), every in-flight request finishes
        with its outputs unchanged, then DRAINING -> CLOSED. Idempotent;
        ``timeout`` bounds the wait in background mode (TimeoutError past
        it, the state stays DRAINING). If the engine dies mid-drain its
        error re-raises here and the state still flips CLOSED."""
        with self._cond:
            if self._state == Lifecycle.CLOSED:
                return
            first = self._state != Lifecycle.DRAINING
            if first:
                _c_drain_started.inc()
            span = _tracing.start_trace(
                "serving.drain", inflight=self._sched.inflight()) \
                if first else _tracing.NULL
            self._state = Lifecycle.DRAINING
            _g_lifecycle_ready.set(0)
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            end = None if timeout is None \
                else time.monotonic() + float(timeout)
            with self._cond:
                while self._sched.has_work and self._error is None:
                    if end is not None and time.monotonic() >= end:
                        span.end("timeout")
                        raise TimeoutError(
                            f"drain: {self._sched.inflight()} requests "
                            f"still in flight after {timeout}s")
                    self._cond.wait(0.02)
        else:
            with self._lock:
                while self._sched.has_work and self._error is None:
                    self._sched.step()
        with self._cond:
            was_closed = self._state == Lifecycle.CLOSED
            self._state = Lifecycle.CLOSED
            err = self._error
        if err is not None:
            span.annotate(completed=False)
            span.end("error")
            raise RuntimeError(
                "drain: engine died before in-flight work could "
                "finish") from err
        if not was_closed:  # a concurrent drain lost the race: one edge
            _c_drain_completed.inc()
        # the first drainer's span, whichever thread closed the engine
        span.annotate(completed=True)
        span.end("CLOSED")

    def _drive(self):
        try:
            while True:
                with self._cond:
                    while not self._sched.has_work:
                        if self._closed:
                            return
                        self._cond.wait()
                    if self._closed and not self._sched.has_work:
                        return
                self.step()
        except BaseException as e:  # noqa: BLE001 — fail loud, not silent
            with self._cond:
                self._error = e
                self._sched.fail_all()
            resilience.degrade("serving.engine", exc=e)

    # -- telemetry export ----------------------------------------------

    def serve_metrics(self, port=0, host="127.0.0.1", store=None,
                      replica_id=None):
        """Attach a scrapeable telemetry endpoint to this engine
        (idempotent; closed with the engine) and return it: ``/metrics``
        (OpenMetrics text), ``/metrics/delta`` (per-second rates),
        ``/healthz`` (SLO gauges and engine liveness: 503 once the driver
        died or the engine closed), ``/readyz`` (the drain lifecycle: 503
        unless READY), ``/alerts`` (this engine's SLO incidents),
        ``/summary``, ``/traces`` and ``/traces/<id>``. ``port=0`` binds
        an ephemeral port: read the bound one from ``.port`` /
        ``.url()``. ``store`` (the fleet registry, ``profiler/fleet.py``)
        is not ported and raises ``NotImplementedError``."""
        if store is not None:
            raise NotImplementedError(
                "serve_metrics(store=...) registers the replica with the "
                "fleet registry (profiler/fleet.py), which is not ported "
                "yet (ROADMAP.md)")
        with self._lock:
            if self._metrics_server is None:
                from ..profiler.export import MetricsServer
                self._metrics_server = MetricsServer(
                    port=port, host=host, health_extra=self._health_view,
                    alerts=self._sched.alerts, ready=self._ready_view)
            return self._metrics_server

    def _health_view(self):
        with self._lock:
            alive = self._error is None and not self._closed
            view = {"engine": {
                "closed": self._closed,
                "lifecycle": self._state,
                "queue": len(self._sched.queue),
                "running": len(self._sched.running)}}
            if self._error is not None:
                view["engine"]["error"] = \
                    f"{type(self._error).__name__}: {self._error}"
        if not alive:
            view["status"] = "draining" if self._error is None \
                else "dead"
        return view

    def _ready_view(self):
        """/readyz body: routability, apart from /healthz liveness: a
        DRAINING engine is alive but must receive no new traffic."""
        with self._lock:
            state = self._state
            body = {"ready": state == Lifecycle.READY
                    and self._error is None,
                    "state": state, "attached": True,
                    "inflight": self._sched.inflight()}
            if self._error is not None:
                body["error"] = \
                    f"{type(self._error).__name__}: {self._error}"
        return body

    def close(self, cancel_pending=True, timeout=60):
        """Stop serving. ``cancel_pending=True`` (default) cancels every
        live request (they end CANCELLED at the final sweep); ``False``
        lets them finish first."""
        with self._cond:
            self._closed = True
            self._state = Lifecycle.CLOSED
            _g_lifecycle_ready.set(0)
            if cancel_pending:
                for req in list(self._sched.queue):
                    req.cancel_requested = True
                for req in list(self._sched.running.values()):
                    req.cancel_requested = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        # foreground mode (or a dead driver): flush the remaining work so
        # every handle reaches a terminal status
        with self._lock:
            if self._error is None:
                while self._sched.has_work:
                    self._sched.step()
            server, self._metrics_server = self._metrics_server, None
        if server is not None:
            server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
