"""Telemetry export: OpenMetrics text, delta rates, the HTTP endpoint
(mirrors ``paddle_tpu/profiler/export.py``).

- ``render_prometheus()``: the registry (``profiler/metrics.py``), or
  one prefix family, as OpenMetrics text: counters as ``_total``, gauges
  plain, histograms as cumulative ``_bucket{le=...}`` series with
  ``_sum``/``_count`` and bucket exemplars (``# {trace_id="..."} value
  ts``) that name traces the span ring exports; a full render ends with
  the ``replica_info`` identity gauge, and every render with ``# EOF``.
- ``parse_prometheus()`` / ``render_parsed()``: the round trip, label
  aware (a series with labels beyond ``le`` keys as ``name{k="v"}``).
- ``DeltaRates``: successive snapshots diffed into per-second rates;
  monotone series clamp a negative delta (a counter reset) to 0, gauges
  keep their sign.
- ``MetricsServer``: a stdlib ``http.server`` on ``127.0.0.1`` (port 0
  binds an ephemeral port, read back from ``.port`` / ``.url()``):

  =====================  ==============================================
  ``/metrics``           OpenMetrics text
  ``/metrics/delta``     JSON per-second rates since the last delta call
  ``/healthz``           JSON liveness and the serving SLO gauges (503
                         once the attached engine died or closed)
  ``/readyz``            JSON routability: 200 only while the attached
                         engine is READY
  ``/alerts``            JSON active and resolved incidents of the
                         attached ``AlertManager`` (the same body shape,
                         ``attached: false``, without one)
  ``/summary``           ``profiler.summary_text()``, plain text
  ``/traces``            the whole span ring, Chrome/Perfetto JSON
  ``/traces/<trace_id>`` one trace (404 when unknown)
  =====================  ==============================================

``ServingEngine.serve_metrics()`` attaches one to an engine.
"""

from __future__ import annotations

import json
import re
import threading
import time

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["render_prometheus", "parse_prometheus", "render_parsed",
           "DeltaRates", "MetricsServer"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _pname(name):
    """Registry name -> Prometheus metric name (dots become
    underscores; leading digits cannot occur in our registry)."""
    return _NAME_RE.sub("_", name)


def _fnum(v):
    """Float formatting matching Prometheus conventions: integral
    values render bare, +inf as ``+Inf``."""
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


# label-value escaping lives in metrics, which renders the same label
# blocks
_esc_label = _metrics._esc_label_value


def _unesc_label(v):
    return v.replace("\\n", "\n").replace('\\"', '"') \
        .replace("\\\\", "\\")


def _labelblock(labels, **extra):
    """``{k="v",...}`` block for a sample line (sorted-key canonical;
    empty string when there are no labels at all). Values are escaped;
    the parser unescapes — key canonicalization therefore happens on
    the ESCAPED form on both sides, so render/parse keys agree.
    Delegates to ``metrics._label_body`` so registry keys
    (``metrics.label_key``) and rendered sample lines share one
    implementation."""
    items = {**(labels or {}), **extra}
    if not items:
        return ""
    return "{" + _metrics._label_body(items) + "}"


def _identity_lines(labels=None):
    """The ``replica_info`` gauge: value 1, identity as labels — the
    OpenMetrics idiom (cf. Prometheus ``target_info``) for stamping
    WHO produced a scrape without relabeling every series. Caller
    labels win on collision (a renamed replica stays consistent with
    its other series)."""
    ident = _metrics.replica_identity()
    merged = {k: ident[k] for k in
              ("replica_id", "host", "pid", "start_ts")}
    merged.update(labels or {})
    return ["# TYPE replica_info gauge",
            f"replica_info{_labelblock(merged)} 1"]


def render_prometheus(prefix=None, labels=None):
    """OpenMetrics text for every registered metric (optionally one
    ``prefix`` family). ``labels`` (a flat str dict) is stamped onto
    every sample line (per-replica series); the per-process exposition
    is unlabeled. Full (un-prefixed) renders append the ``replica_info``
    identity gauge. Ends with ``# EOF`` per the spec."""
    with _metrics.registry._lock:
        items = sorted(_metrics.registry._metrics.items())
    lines, typed = [], set()
    lb = _labelblock(labels)
    for name, m in items:
        if prefix is not None and not name.startswith(prefix):
            continue
        # labeled instruments (per-slice KV gauges, metrics.label_key
        # registry keys) render their own labels MERGED with the
        # caller's stamp — the stamp wins on collision, matching the
        # replica_info precedence
        own = getattr(m, "labels", None)
        mlb = _labelblock({**own, **(labels or {})}) if own else lb
        pn = _pname(m.name)
        # TYPE once per family: labeled slices of one gauge share a
        # base name across registry keys, and OpenMetrics rejects
        # repeated metric-family metadata
        typeline = pn not in typed
        typed.add(pn)
        if isinstance(m, _metrics.Counter):
            if typeline:
                lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn}_total{mlb} {_fnum(m.value)}")
        elif isinstance(m, _metrics.Gauge):
            if typeline:
                lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn}{mlb} {_fnum(m.value)}")
        elif isinstance(m, _metrics.Histogram):
            snap = m._snap()
            if typeline:
                lines.append(f"# TYPE {pn} histogram")
            cum = 0
            bounds = [*m.bounds, float("inf")]
            blabels = [*map(str, m.bounds), "+inf"]
            for b, label in zip(bounds, blabels):
                cum += snap["buckets"][label]
                bb = _labelblock(labels, le=_fnum(b))
                line = f"{pn}_bucket{bb} {cum}"
                ex = snap["exemplars"].get(label)
                if ex is not None:
                    line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                             f'{_fnum(ex["value"])} {ex["ts"]:.3f}')
                lines.append(line)
            lines.append(f"{pn}_sum{lb} {_fnum(snap['sum'])}")
            lines.append(f"{pn}_count{lb} {snap['count']}")
    if prefix is None:
        lines.extend(_identity_lines(labels))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>[^ #]+)'
    r'(?:\s*#\s*\{(?P<exlabels>[^}]*)\}\s*(?P<exvalue>\S+)'
    r'(?:\s+(?P<exts>\S+))?)?\s*$')


def _labels(s):
    """Parse a label block body. Values unescape the render-side
    escapes (quote/backslash/newline); pathological values containing
    bare ``,``/``}`` are beyond this parser — keep label values to
    identifier-ish strings (replica ids, trace ids)."""
    out = {}
    for part in (s or "").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = _unesc_label(v.strip().strip('"'))
    return out


def parse_prometheus(text):
    """Parse an exposition back into plain data::

        {key: {"type": ..., "name": base_name, "value": ...}}       scalars
        {key: {"type": "histogram", "name": base_name,
               "buckets": {le: cum}, "sum": ..., "count": ...,
               "exemplars": {le: {"trace_id", "value"}}}}

    ``key`` is the base metric name for unlabeled series (everything the
    per-process /metrics serves), or ``name{k="v",...}`` (sorted-key
    canonical, ``le`` excluded) for labeled series, whose entries also
    carry the ``labels`` dict. Counter
    ``_total`` / histogram series suffixes fold back onto the base
    name. Raises ValueError on a malformed sample line — this is the
    round-trip check, so garbage must not parse silently."""
    out = {}

    def base(name, kind, labels):
        key = name + _labelblock(labels) if labels else name
        e = out.setdefault(key, {"type": kind, "name": name}
                           if kind != "histogram"
                           else {"type": kind, "name": name,
                                 "buckets": {}, "sum": None,
                                 "count": None, "exemplars": {}})
        if labels:
            e["labels"] = dict(labels)
        return e

    types = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, value = m.group("name"), float(m.group("value"))
        labels = _labels(m.group("labels"))
        le = labels.pop("le", None)
        for suffix, field in (("_bucket", "buckets"), ("_sum", "sum"),
                              ("_count", "count")):
            stem = name[:-len(suffix)] if name.endswith(suffix) else None
            if stem and types.get(stem) == "histogram":
                h = base(stem, "histogram", labels)
                if field == "buckets":
                    h["buckets"][le] = value
                    if m.group("exvalue") is not None:
                        h["exemplars"][le] = {
                            **_labels(m.group("exlabels")),
                            "value": float(m.group("exvalue"))}
                else:
                    h[field] = value
                break
        else:
            if name.endswith("_total") and \
                    types.get(name[:-len("_total")]) == "counter":
                base(name[:-len("_total")], "counter",
                     labels)["value"] = value
            else:
                base(name, types.get(name, "gauge"),
                     labels)["value"] = value
    return out


_le_sort_key = _metrics._le_sort_key


def render_parsed(parsed):
    """Inverse of :func:`parse_prometheus`: plain parsed/merged data
    back to OpenMetrics text that parse_prometheus round-trips
    (exemplars included; their wall-clock ``ts`` is not
    retained by the parser, so a re-render omits it — the OpenMetrics
    timestamp is optional)."""
    lines, typed = [], set()
    for key in sorted(parsed):
        e = parsed[key]
        name = e.get("name") or key
        kind = e.get("type", "gauge")
        labels = e.get("labels")
        lb = _labelblock(labels)
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)
        if kind == "counter":
            lines.append(f"{name}_total{lb} {_fnum(e['value'])}")
        elif kind == "histogram":
            for le in sorted(e.get("buckets") or {}, key=_le_sort_key):
                bb = _labelblock(labels, le=le)
                line = f"{name}_bucket{bb} {_fnum(e['buckets'][le])}"
                ex = (e.get("exemplars") or {}).get(le)
                if ex is not None and ex.get("trace_id"):
                    line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                             f'{_fnum(ex["value"])}')
                lines.append(line)
            if e.get("sum") is not None:
                lines.append(f"{name}_sum{lb} {_fnum(e['sum'])}")
            if e.get("count") is not None:
                lines.append(f"{name}_count{lb} {_fnum(e['count'])}")
        else:
            lines.append(f"{name}{lb} {_fnum(e['value'])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class DeltaRates:
    """Per-second rates between successive ``rates()`` calls: counters
    and histogram counts/sums (and, with ``include_buckets=True``,
    per-bucket counts as ``name.le.<bound>`` — what the burn-rate alert
    rules consume) diffed against the previous snapshot. First call
    primes the baseline and returns {}.

    Monotone series (counters, histogram counts/sums/buckets) clamp
    negative deltas to zero: a fresh process scraping the same endpoint
    — or a ``metrics.reset()`` between benchmark runs — resets the
    underlying counter, and a counter reset must read as "no events
    yet", never as a negative rate. Gauge deltas keep their sign (a
    shrinking queue IS a negative derivative, and the queue-growth
    alert rule relies on it)."""

    def __init__(self, prefix=None, include_buckets=False):
        self.prefix = prefix
        self.include_buckets = include_buckets
        self._prev = None
        self._prev_t = None
        self._lock = threading.Lock()

    def _flatten(self, snap):
        """(flat values, set of monotone names)."""
        flat, mono = {}, set()
        kinds = _metrics.registry.kinds(self.prefix)
        for name, v in snap.items():
            if isinstance(v, dict):
                flat[name + ".count"] = v["count"]
                flat[name + ".sum"] = v["sum"]
                mono.add(name + ".count")
                mono.add(name + ".sum")
                if self.include_buckets:
                    for label, c in (v.get("buckets") or {}).items():
                        key = f"{name}.le.{label}"
                        flat[key] = c
                        mono.add(key)
            else:
                flat[name] = v
                if kinds.get(name) is _metrics.Counter:
                    mono.add(name)
        return flat, mono

    def rates(self):
        now = time.monotonic()
        cur, mono = self._flatten(_metrics.snapshot(self.prefix))
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = cur, now
        if prev is None:
            return {}
        dt = max(now - prev_t, 1e-9)
        out = {}
        for name, v in cur.items():
            if not isinstance(v, (int, float)):
                continue
            d = v - prev.get(name, 0)
            if name in mono and d < 0:
                d = 0  # counter reset (fresh process / metrics.reset)
            out[name] = d / dt
        return out


def _slo_health(extra=None):
    """/healthz body: liveness + the serving SLO gauges a router
    health-checks (queue depth, live slots, KV pressure) and the
    terminal counters whose first derivative is the alert."""
    snap = _metrics.snapshot("serving.")
    body = {"status": "ok", "ts": time.time(),
            "slo": {k: snap[k] for k in
                    ("serving.queue.depth", "serving.slots.running",
                     "serving.kv.utilization") if k in snap},
            "counters": {k: snap[k] for k in
                         ("serving.completed", "serving.timeout",
                          "serving.rejected", "serving.preempt",
                          "serving.errors") if k in snap}}
    if extra:
        try:
            body.update(extra() or {})
        except Exception as e:  # noqa: BLE001 — health must not 500
            body["status"] = "error"
            body["error"] = f"{type(e).__name__}: {e}"
    return body


class MetricsServer:
    """Threaded stdlib HTTP endpoint over the registry + trace ring.
    Binds at construction (``port=0``, the default, binds an EPHEMERAL
    port — read the actually-bound one from ``.port`` / ``.address`` /
    ``url()``; never hardcode ports in tests or router configs);
    ``close()`` stops it. ``health_extra`` is an optional zero-arg
    callable merged into /healthz (ServingEngine passes its
    engine-state view); ``alerts`` an optional
    ``profiler.alerts.AlertManager`` served from
    ``/alerts`` (each GET also nudges its rate-limited evaluation);
    ``ready`` an optional zero-arg callable returning the ``/readyz``
    body (must carry a boolean ``ready`` — ServingEngine passes its
    drain-lifecycle view). Without one, ``/readyz``
    reports ready (a bare metrics process is routable)."""

    def __init__(self, port=0, host="127.0.0.1", health_extra=None,
                 alerts=None, ready=None):
        import http.server

        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr
                pass

            def _send(self, code, body, ctype):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path == "/metrics":
                        self._send(
                            200, render_prometheus(),
                            "application/openmetrics-text; version=1.0.0;"
                            " charset=utf-8")
                    elif path == "/metrics/delta":
                        self._send(200, json.dumps(server._delta.rates()),
                                   "application/json")
                    elif path == "/healthz":
                        body = _slo_health(server._health_extra)
                        code = 200 if body["status"] == "ok" else 503
                        self._send(code, json.dumps(body),
                                   "application/json")
                    elif path == "/readyz":
                        body = server._ready_body()
                        code = 200 if body.get("ready") else 503
                        self._send(code, json.dumps(body),
                                   "application/json")
                    elif path == "/alerts":
                        mgr = server._alerts
                        if mgr is None:
                            # same body shape as the attached branch —
                            # pollers index these keys unconditionally
                            body = {"attached": False, "active": [],
                                    "history": [], "rules": [],
                                    "window_s": None}
                        else:
                            mgr.maybe_evaluate()
                            body = {"attached": True, **mgr.as_dict()}
                        self._send(200, json.dumps(body),
                                   "application/json")
                    elif path == "/summary":
                        # the human view without a Python shell; lazy
                        # import: the profiler package imports this module
                        from . import summary_text
                        self._send(200, summary_text(),
                                   "text/plain; charset=utf-8")
                    elif path == "/traces":
                        self._send(200,
                                   json.dumps(_tracing.export_ring()),
                                   "application/json")
                    elif path.startswith("/traces/"):
                        tid = path[len("/traces/"):]
                        trace = _tracing.export_trace(tid)
                        if not trace["traceEvents"]:
                            self._send(404, json.dumps(
                                {"error": f"unknown trace {tid!r}"}),
                                "application/json")
                        else:
                            self._send(200, json.dumps(trace),
                                       "application/json")
                    else:
                        self._send(404, json.dumps(
                            {"error": f"no route {path!r}"}),
                            "application/json")
                except BrokenPipeError:  # scraper went away mid-write
                    pass

        self._health_extra = health_extra
        self._alerts = alerts
        self._ready = ready
        self._delta = DeltaRates()
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        # the ACTUALLY-BOUND address: with port=0 the kernel picks an
        # ephemeral port, so callers must read it back from here
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="paddle-tpu-torch-metrics-http", daemon=True)
        self._thread.start()

    def _ready_body(self):
        """/readyz body: the attached lifecycle view, or standalone
        readiness when nothing is attached. Never raises — a broken
        view must read as NOT ready (a router should stop sending
        traffic, not get a 500)."""
        if self._ready is None:
            return {"ready": True, "state": "READY", "attached": False}
        try:
            return self._ready()
        except Exception as e:  # noqa: BLE001 — readiness must not 500
            return {"ready": False, "state": "ERROR",
                    "error": f"{type(e).__name__}: {e}"}

    @property
    def address(self):
        """``(host, port)`` as actually bound."""
        return (self.host, self.port)

    def url(self, path="/metrics"):
        return f"http://{self.host}:{self.port}{path}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
