"""Always-on runtime metrics registry (mirrors
``paddle_tpu/profiler/metrics.py``).

Three instrument kinds, Prometheus-shaped:

- ``Counter``   — monotone event count (``inc``)
- ``Gauge``     — last-write-wins level (``set`` / ``add``)
- ``Histogram`` — value distribution (``observe``): count / sum / min /
  max plus fixed-bound bucket counts

All mutation is lock-guarded (the serving frontend's driver thread and
its callers both touch the registry), and ``snapshot()`` returns a copy
so a reader never observes later mutation. The serving layers register
their ``serving.*`` instruments under the reference's names, so a test
can compare the two registries' deltas name by name.

    from paddle_tpu_torch.profiler import metrics
    metrics.counter("my.events").inc()
    metrics.histogram("my.latency_us").observe(dt)
    metrics.snapshot("serving.")   # {name: value | dict} plain data

Each histogram bucket keeps one exemplar: the largest observation made
while a trace was active, with its trace id (``profiler/tracing.py``
installs the trace-id source at import), so a tail bucket of
``serving.ttft_us`` names a trace that ``tracing.export_trace`` renders.

Not ported: the HTTP exporter (``profiler/export.py``), replica identity,
labeled gauges and JAX compile monitoring (its counterpart, kernel-build
seconds per thread, is ``kernels._build.thread_build_seconds``).
"""

from __future__ import annotations

import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "counter",
           "gauge", "histogram", "snapshot", "registry",
           "cumulative_buckets", "percentile_from_buckets",
           "window_delta"]


# -- histogram exemplars -----------------------------------------------------
# profiler.tracing installs the ambient-trace probe at import; until then
# an observation pays one call returning None. The hook lives here, not an
# import of tracing, because tracing needs this module's counters.

def _no_trace():
    return None


_trace_id_fn = _no_trace


def _set_trace_id_source(fn):
    global _trace_id_fn
    _trace_id_fn = fn


class Counter:
    """Monotonically increasing event count."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _snap(self):
        return self._value


class Gauge:
    """Last-write-wins level (queue depth, blocks in use, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._value = v

    def add(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _snap(self):
        return self._value


# default bounds: small counts and microsecond-scale latencies —
# override per histogram at creation
_DEFAULT_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class Histogram:
    """Fixed-bucket distribution: bucket[i] counts observations
    <= bounds[i]; one overflow bucket catches the rest. Each bucket keeps
    an exemplar: (value, trace_id, wall time) of its largest observation
    made inside a trace."""

    __slots__ = ("name", "bounds", "_buckets", "_count", "_sum", "_min",
                 "_max", "_exemplars", "_lock")

    def __init__(self, name, bounds=_DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(sorted(bounds))
        self._lock = threading.Lock()
        self._buckets = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._exemplars = [None] * (len(self.bounds) + 1)

    def observe(self, v):
        tid = _trace_id_fn()
        with self._lock:
            i = 0
            for b in self.bounds:
                if v <= b:
                    break
                i += 1
            self._buckets[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if tid is not None:
                ex = self._exemplars[i]
                if ex is None or v >= ex[0]:
                    self._exemplars[i] = (v, tid, time.time())

    def _pct_locked(self, q):
        """The q-quantile (0..1) from the bucket counts: linear
        interpolation inside the covering bucket, edge buckets clamped to
        the observed min/max."""
        if not self._count:
            return None
        target = q * self._count
        cum = 0
        for i, n in enumerate(self._buckets):
            if not n:
                continue
            lo = self.bounds[i - 1] if i > 0 else self._min
            hi = self.bounds[i] if i < len(self.bounds) else self._max
            lo = min(max(lo, self._min), self._max)
            hi = min(max(hi, lo), self._max)
            if cum + n >= target:
                frac = (target - cum) / n
                return lo + (hi - lo) * frac
            cum += n
        return self._max

    def _snap(self):
        with self._lock:
            labels = [*map(str, self.bounds), "+inf"]
            exemplars = {labels[i]: {"value": ex[0], "trace_id": ex[1],
                                     "ts": ex[2]}
                         for i, ex in enumerate(self._exemplars)
                         if ex is not None}
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "avg": (self._sum / self._count) if self._count
                    else None,
                    "p50": self._pct_locked(0.50),
                    "p95": self._pct_locked(0.95),
                    "p99": self._pct_locked(0.99),
                    "buckets": dict(zip(labels, list(self._buckets))),
                    "exemplars": exemplars}


class Registry:
    """Name -> instrument. Get-or-create is locked; call sites keep the
    returned objects, so the steady-state cost is one ``inc``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, **kw)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, bounds=_DEFAULT_BOUNDS):
        return self._get(name, Histogram, bounds=bounds)

    def snapshot(self, prefix=None):
        """Plain-data copy of every metric (``prefix`` restricts to one
        family, e.g. ``"serving."``), isolated from later updates."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m._snap() for name, m in items
                if prefix is None or name.startswith(prefix)}

    def kinds(self, prefix=None):
        """{name: instrument class} of the registered metrics."""
        with self._lock:
            return {name: type(m) for name, m in self._metrics.items()
                    if prefix is None or name.startswith(prefix)}


registry = Registry()

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram
snapshot = registry.snapshot


# -- snapshot arithmetic -----------------------------------------------------

def _le_sort_key(le):
    return float("inf") if le in ("+Inf", "+inf") else float(le)


def cumulative_buckets(buckets):
    """Per-bucket ``{le: count}`` (the snapshot form) to cumulative
    ``{le: cum_count}``, ordered by bound."""
    items = sorted((_le_sort_key(le), le, c)
                   for le, c in (buckets or {}).items())
    out, cum = {}, 0
    for _, le, c in items:
        cum += c
        out[le] = cum
    return out


def percentile_from_buckets(buckets, q):
    """q-quantile (0..1) from a cumulative bucket map ``{le_label:
    cumulative_count}``: linear interpolation inside the covering bucket,
    0-floored and clamped to the last finite bound for the +inf bucket.
    None on an empty histogram."""
    items = sorted((_le_sort_key(le), c)
                   for le, c in (buckets or {}).items())
    if not items:
        return None
    total = items[-1][1]
    if not total:
        return None
    target = q * total
    prev_bound, prev_cum, last_finite = 0.0, 0, 0.0
    for bound, cum in items:
        finite = bound != float("inf")
        if cum >= target:
            n = cum - prev_cum
            frac = (target - prev_cum) / n if n else 1.0
            hi = bound if finite else max(prev_bound, last_finite)
            return prev_bound + (hi - prev_bound) * frac
        if finite:
            last_finite = bound
        prev_bound, prev_cum = (bound if finite else prev_bound), cum
    return last_finite


def _hist_delta(cur, prev):
    """Windowed slice of one histogram snapshot: bucket, count and sum
    diffs and the window's percentiles (min/max are not recoverable from
    two snapshots and stay None). A reset() between the snapshots makes
    ``cur`` a fresh start."""
    pb = prev.get("buckets") if isinstance(prev, dict) else None
    buckets = {le: c - (pb.get(le, 0) if pb else 0)
               for le, c in cur["buckets"].items()}
    count = cur["count"] - (prev["count"] if isinstance(prev, dict) else 0)
    total = cur["sum"] - (prev["sum"] if isinstance(prev, dict) else 0)
    if count < 0 or any(v < 0 for v in buckets.values()):
        buckets = dict(cur["buckets"])
        count, total = cur["count"], cur["sum"]
    cum = cumulative_buckets(buckets)
    return {"count": count, "sum": total,
            "avg": (total / count) if count else None,
            "min": None, "max": None,
            "p50": percentile_from_buckets(cum, 0.50),
            "p95": percentile_from_buckets(cum, 0.95),
            "p99": percentile_from_buckets(cum, 0.99),
            "buckets": buckets}


def window_delta(before, after):
    """``after - before`` over two :func:`snapshot` maps: scalars become
    signed numeric deltas, histograms windowed dicts; metrics born after
    ``before`` diff against zero."""
    out = {}
    for name, cur in after.items():
        prev = before.get(name)
        if isinstance(cur, dict):
            out[name] = _hist_delta(cur, prev)
        else:
            prev_v = prev if isinstance(prev, (int, float)) else 0
            out[name] = cur - prev_v
    return out
