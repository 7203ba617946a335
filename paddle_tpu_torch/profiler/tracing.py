"""Request-scoped tracing: sampled, bounded spans (mirrors
``paddle_tpu/profiler/tracing.py``).

The metrics registry answers "how often, how slow on aggregate"; this
layer answers which request, and where its time went. A trace context
(trace_id, span_id) rides a ``contextvars.ContextVar`` through the code
that serves one request; each instrumented slice (queue wait, prefill,
decode step, preemption, the terminal status) records a **span**: trace,
span and parent ids, name, wall-clock start, duration, thread and
attributes, into a fixed-size per-process ring.

- **Nearly free when disabled.** Every entry point gates on one module
  global, refreshed only when the flags epoch moves
  (``core.flags.epoch``); a disabled ``span()`` returns the preallocated
  :data:`NULL` span.
- **Sampled at the root.** ``start_trace`` decides once per trace
  (``FLAGS_trace_sample``); children of an unsampled root take the same
  null path.
- **Bounded memory.** Spans land in a ring of ``FLAGS_trace_ring`` slots;
  ``export_trace`` / ``export_ring`` render Chrome / Perfetto trace-event
  JSON from what the ring still holds.

``current_context()`` returns a small picklable dict and ``attach(ctx)``
adopts it; the scheduler attaches a request's root span around its SLO
histogram observations, so their exemplars (``profiler/metrics.py``)
name the request's trace.

    from paddle_tpu_torch.profiler import tracing

    root = tracing.start_trace("serving.request", rid=7)
    with tracing.span("prefill", parent=root, tokens=128):
        ...
    root.end("DONE")
    tracing.export_trace(root.trace_id)   # {"traceEvents": [...]}
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time

from ..core import flags as flags_mod
from . import metrics as _metrics

__all__ = ["Span", "NULL", "start_trace", "span", "record_span", "attach",
           "current_context", "current_trace_id", "get_trace",
           "trace_ids", "export_trace", "export_ring", "records",
           "enabled", "reset"]

# (trace_id, span_id) of the innermost active span on this thread or
# task; None outside any sampled trace
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_trace", default=None)

_C_TRACES = _metrics.counter("trace.traces")
_C_SPANS = _metrics.counter("trace.spans")
_C_UNSAMPLED = _metrics.counter("trace.unsampled")


class _Ring:
    """Fixed-size span store: an append overwrites the oldest slot."""

    __slots__ = ("cap", "_buf", "_n", "_lock")

    def __init__(self, cap):
        self.cap = max(int(cap), 1)
        self._buf = [None] * self.cap
        self._n = 0
        self._lock = threading.Lock()

    def append(self, rec):
        with self._lock:
            self._buf[self._n % self.cap] = rec
            self._n += 1

    def records(self):
        with self._lock:
            n, cap = self._n, self.cap
            if n <= cap:
                return list(self._buf[:n])
            i = n % cap
            return self._buf[i:] + self._buf[:i]

    def clear(self):
        with self._lock:
            self._buf = [None] * self.cap
            self._n = 0


# span() and start_trace() read _ENABLED after one int compare of the
# flags epoch; the rest is refreshed only when set_flags moves it
_ENABLED = True
_SAMPLE = 1.0
_EPOCH_SEEN = -1
_ring = _Ring(4096)
_refresh_lock = threading.Lock()


def _gate():
    if flags_mod.epoch() != _EPOCH_SEEN:
        _refresh()
    return _ENABLED


def _refresh():
    global _ENABLED, _SAMPLE, _EPOCH_SEEN, _ring
    with _refresh_lock:
        ep = flags_mod.epoch()
        sample = float(flags_mod.flag("FLAGS_trace_sample"))
        cap = int(flags_mod.flag("FLAGS_trace_ring"))
        if cap > 0 and cap != _ring.cap:
            _ring = _Ring(cap)  # a resize drops the history
        _SAMPLE = sample
        _ENABLED = bool(flags_mod.flag("FLAGS_trace_enable")) \
            and sample > 0.0
        _EPOCH_SEEN = ep


def enabled():
    """True when tracing is armed (flag on and sample rate > 0)."""
    return _gate()


# a private RNG: a user's random.seed(k) must neither make two processes
# mint the same trace ids nor lose draws to tracing
_rng = random.Random()


def _new_id():
    return f"{_rng.getrandbits(64):016x}"


class _NullSpan:
    """The no-op span every entry point returns when tracing is off or
    the trace was not sampled."""

    __slots__ = ()
    trace_id = None
    span_id = None
    recording = False

    def annotate(self, **attrs):
        pass

    def end(self, status="ok"):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NULL = _NullSpan()


class Span:
    """One recorded slice. Used as a context manager (it sets the ambient
    context, so nested spans parent to it) or held and ended with
    ``end()``: a serving request's root span lives from submit to its
    terminal status, across threads."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "args",
                 "_wall_us", "_start_ns", "_ended", "_token")

    recording = True

    def __init__(self, trace_id, span_id, parent_id, name, args):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.args = args
        self._wall_us = time.time_ns() / 1000.0
        self._start_ns = time.perf_counter_ns()
        self._ended = False
        self._token = None

    def annotate(self, **attrs):
        """Attach attributes (merged into ``args`` when recorded)."""
        if self.args:
            self.args.update(attrs)
        else:
            self.args = attrs

    def end(self, status="ok"):
        """Record the span into the ring, once; ``status`` is a free-form
        label ("ok", "error", a terminal request status)."""
        if self._ended:
            return
        self._ended = True
        rec = {"trace": self.trace_id, "span": self.span_id,
               "parent": self.parent_id, "name": self.name,
               "ts": self._wall_us,
               "dur": (time.perf_counter_ns() - self._start_ns) / 1000.0,
               "tid": threading.get_ident(), "status": status}
        if self.args:
            rec["args"] = self.args
        _ring.append(rec)
        _C_SPANS.inc()

    def context(self):
        """Picklable propagation dict."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __enter__(self):
        self._token = _CURRENT.set((self.trace_id, self.span_id))
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self.end("ok" if exc_type is None else "error")
        return False


def start_trace(name, **attrs):
    """Open a root span: a fresh trace_id and the sampling decision.
    Returns :data:`NULL` when tracing is off or the draw lost. Does not
    set the ambient context (roots are held across threads); use it in a
    ``with`` block or pass it as ``parent=``."""
    if not _gate():
        return NULL
    if _SAMPLE < 1.0 and _rng.random() >= _SAMPLE:
        _C_UNSAMPLED.inc()
        return NULL
    _C_TRACES.inc()
    return Span(_new_id(), _new_id(), None, name, attrs or None)


def span(name, parent=None, **attrs):
    """Open a child span of ``parent`` (a Span or a propagation dict),
    else of the ambient context; with no parent anywhere, the null span
    (a slice outside every trace is never recorded)."""
    if not _gate():
        return NULL
    if parent is None:
        cur = _CURRENT.get()
        if cur is None:
            return NULL
        tid, psid = cur
    elif isinstance(parent, Span):
        tid, psid = parent.trace_id, parent.span_id
    elif isinstance(parent, dict):
        tid = parent.get("trace_id")
        if tid is None:
            return NULL
        psid = parent.get("span_id")
    else:  # NULL or anything else not recording
        return NULL
    return Span(tid, _new_id(), psid, name, attrs or None)


def record_span(name, parent, dur_us, **attrs):
    """Record a slice of ``dur_us`` ending now under ``parent`` (a Span),
    after the fact: queue wait, a request's share of a batched decode
    step. A no-op unless the parent is recording."""
    if not getattr(parent, "recording", False) or not _gate():
        return
    rec = {"trace": parent.trace_id, "span": _new_id(),
           "parent": parent.span_id, "name": name,
           "ts": time.time_ns() / 1000.0 - dur_us, "dur": float(dur_us),
           "tid": threading.get_ident(), "status": "ok"}
    if attrs:
        rec["args"] = attrs
    _ring.append(rec)
    _C_SPANS.inc()


@contextlib.contextmanager
def attach(ctx):
    """Adopt a context for the block: a Span, a ``current_context()``
    dict, or None (a no-op)."""
    if ctx is None or not _gate():
        yield
        return
    if isinstance(ctx, Span):
        pair = (ctx.trace_id, ctx.span_id)
    elif isinstance(ctx, dict) and ctx.get("trace_id"):
        pair = (ctx["trace_id"], ctx.get("span_id"))
    else:
        yield
        return
    token = _CURRENT.set(pair)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_context():
    """The ambient context as a picklable dict, or None."""
    cur = _CURRENT.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "span_id": cur[1]}


def current_trace_id():
    """The ambient trace_id or None: the histograms' exemplar source."""
    cur = _CURRENT.get()
    return cur[0] if cur is not None else None


# -- reading the ring ------------------------------------------------------

def records():
    """Every span still in the ring, oldest first."""
    return [r for r in _ring.records() if r is not None]


def get_trace(trace_id):
    """The ring's spans of one trace, by start time (a long trace may
    have partly aged out: export promptly or raise FLAGS_trace_ring)."""
    return sorted((r for r in records() if r["trace"] == trace_id),
                  key=lambda r: r["ts"])


def trace_ids():
    """Distinct trace ids in the ring, most recent last."""
    out, seen = [], set()
    for r in records():
        if r["trace"] not in seen:
            seen.add(r["trace"])
            out.append(r["trace"])
    return out


def _chrome_event(r):
    ev = {"name": r["name"], "ph": "X", "ts": r["ts"], "dur": r["dur"],
          "pid": os.getpid(), "tid": r["tid"], "cat": "trace",
          "args": {"trace_id": r["trace"], "span_id": r["span"],
                   "parent_id": r["parent"], "status": r["status"]}}
    if r.get("args"):
        ev["args"].update(r["args"])
    return ev


def export_trace(trace_id):
    """One trace as Chrome / Perfetto trace-event JSON (a plain dict for
    ``json.dump``)."""
    return {"traceEvents": [_chrome_event(r) for r in get_trace(trace_id)],
            "displayTimeUnit": "ms", "trace_id": trace_id}


def export_ring():
    """The whole ring as one trace-event JSON dict."""
    return {"traceEvents": [_chrome_event(r) for r in records()],
            "displayTimeUnit": "ms"}


def reset():
    """Clear the ring."""
    _ring.clear()


# histograms take the ambient trace_id as a bucket exemplar; wired here so
# metrics.py never imports this module
_metrics._set_trace_id_source(current_trace_id)
