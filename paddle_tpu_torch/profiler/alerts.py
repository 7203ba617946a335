"""SLO burn-rate alerts over the metrics registry (mirrors
``paddle_tpu/profiler/alerts.py``).

Rolling-window rules evaluated over per-second ``export.DeltaRates``
(each evaluation diffs against the previous one, so a window is the time
between evaluations: the scheduler nudges ``maybe_evaluate`` every step,
rate-limited by ``FLAGS_alert_interval_s``):

- ``slo.ttft_burn`` / ``slo.itl_burn``: error-budget burn rate. With an
  SLO of "``FLAGS_slo_target`` of observations under
  ``FLAGS_slo_{ttft,itl}_budget_us``" the burn rate is bad-fraction /
  (1 - target); at least ``FLAGS_alert_burn_threshold`` fires. Fractions
  come from histogram bucket deltas, so the budget snaps up to the
  nearest bucket bound at or above it.
- ``queue.growth``: the admission queue is at least
  ``FLAGS_alert_queue_depth`` deep and grew over the window.
- ``decode.stall``: live slots, the scheduler stepping, and no token
  decoded over the window (an engine that stopped stepping reads idle).
- ``shed.rate``: the overload controller shed load over the window.

Firing is edge-triggered: an incident is recorded once, at the
transition into firing (a flight record ``alert.<rule>`` in
``distributed/watchdog.py``'s ring, stamped with the worst recent
exemplar's trace id where there is one), stays in ``active()`` while the
condition holds, and moves to ``history()`` with a ``resolved`` time on
recovery. ``MetricsServer`` serves the state from ``/alerts``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..core import flags as flags_mod
from . import export as _export
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["AlertRule", "BurnRateRule", "QueueGrowthRule", "StallRule",
           "ShedRateRule", "AlertManager", "default_rules"]

_c_fired = _metrics.counter("alerts.fired")
_c_resolved = _metrics.counter("alerts.resolved")
_c_errors = _metrics.counter("alerts.rule_errors")
_c_evals = _metrics.counter("alerts.evaluations")


class AlertRule:
    """One named condition. ``evaluate(ctx)`` returns ``(firing,
    info)`` where info carries at least ``detail`` (human line) and
    optionally ``value``/``threshold``/``trace_id``. ``ctx`` is
    ``{"rates", "snap", "dt"}`` — per-second delta rates (histogram
    buckets included), the current snapshot, and the window seconds."""

    name = "rule"
    severity = "warn"

    def evaluate(self, ctx):  # pragma: no cover — interface
        raise NotImplementedError


def _worst_exemplar(snap, hist, max_age_s=None):
    """trace_id of the worst RECENT exemplar of ``hist`` — the concrete
    offender an incident should point at. Exemplars are max-value-ever
    per bucket and never age, so without the freshness filter an
    incident could name a cold-start trace from hours ago whose spans
    already rotated out of the ring (a /traces 404 for the operator)."""
    exs = (snap.get(hist) or {}).get("exemplars") or {}
    floor = time.time() - max_age_s if max_age_s else None
    worst = None
    for ex in exs.values():
        if not ex.get("trace_id"):
            continue
        if floor is not None and ex.get("ts", 0) < floor:
            continue
        if worst is None or ex["value"] > worst["value"]:
            worst = ex
    return worst["trace_id"] if worst else None


def _exemplar_age(ctx):
    """Freshness horizon for incident trace stamps: a couple of
    evaluation windows (floored so short test windows still resolve)."""
    return max(2.0 * ctx["dt"], 60.0)


class BurnRateRule(AlertRule):
    """Error-budget burn over one latency histogram."""

    severity = "page"

    def __init__(self, name, hist, budget_flag, min_samples=3):
        self.name = name
        self.hist = hist
        self.budget_flag = budget_flag
        self.min_samples = min_samples

    def evaluate(self, ctx):
        rates, dt = ctx["rates"], ctx["dt"]
        crate = rates.get(self.hist + ".count", 0.0)
        if crate * dt < self.min_samples:
            return False, {}
        budget = float(flags_mod.flag(self.budget_flag))
        target = float(flags_mod.flag("FLAGS_slo_target"))
        threshold = float(flags_mod.flag("FLAGS_alert_burn_threshold"))
        prefix = self.hist + ".le."
        buckets = []
        for key, r in rates.items():
            if key.startswith(prefix):
                label = key[len(prefix):]
                buckets.append((float("inf") if label == "+inf"
                                else float(label), r))
        # snap the budget UP to the nearest bucket bound at or above it
        # (bucket counts can't split below their bound; snapping down
        # would count in-SLO observations as budget burn)
        cutoff = min((b for b, _ in buckets if b >= budget),
                     default=float("inf"))
        # +inf <= cutoff only when the budget itself snapped to +inf —
        # then everything is within budget by definition
        good = sum(r for b, r in buckets if b <= cutoff)
        bad_frac = max(0.0, 1.0 - good / crate)
        burn = bad_frac / max(1.0 - target, 1e-9)
        if burn < threshold:
            return False, {}
        return True, {
            "value": round(burn, 3), "threshold": threshold,
            "trace_id": _worst_exemplar(ctx["snap"], self.hist,
                                        _exemplar_age(ctx)),
            "detail": (f"{bad_frac:.1%} of {self.hist} over "
                       f"{budget:.0f}us budget (burn {burn:.2f}x, "
                       f"target {target})")}


class QueueGrowthRule(AlertRule):
    """Admission queue deep AND growing over the window."""

    name = "queue.growth"

    def evaluate(self, ctx):
        depth = ctx["snap"].get("serving.queue.depth", 0)
        floor = int(flags_mod.flag("FLAGS_alert_queue_depth"))
        growth = ctx["rates"].get("serving.queue.depth", 0.0)
        if depth < floor or growth <= 0.0:
            return False, {}
        return True, {
            "value": depth, "threshold": floor,
            "trace_id": _worst_exemplar(ctx["snap"],
                                        "serving.queue_wait_us",
                                        _exemplar_age(ctx)),
            "detail": (f"queue depth {depth} >= {floor} and growing "
                       f"{growth:+.2f}/s — demand outrunning capacity")}


class StallRule(AlertRule):
    """Live slots, the scheduler IS stepping, yet zero decode progress
    across the window: a genuine livelock (admission churn, device
    returning without tokens). A driver that stopped stepping entirely
    is a different failure — /healthz engine liveness catches that —
    and a caller-driven engine paused between step() calls is healthy,
    so zero steps in the window must read as idle, not wedged."""

    name = "decode.stall"
    severity = "page"

    def evaluate(self, ctx):
        running = ctx["snap"].get("serving.slots.running", 0)
        if running < 1 or ctx["dt"] <= 0.0:
            return False, {}
        if ctx["rates"].get("serving.steps", 0.0) <= 0.0:
            return False, {}  # not being driven: idle, not stalled
        if ctx["rates"].get("serving.decoded_tokens", 0.0) > 0.0:
            return False, {}
        return True, {
            "value": running,
            "trace_id": _worst_exemplar(ctx["snap"], "serving.itl_us",
                                        _exemplar_age(ctx)),
            "detail": (f"{running} running slot(s) decoded ZERO tokens "
                       f"over {ctx['dt']:.1f}s — engine stalled")}


class ShedRateRule(AlertRule):
    """The overload controller is actively shedding load
    (serving/overload.py): the ``serving.shed`` counter moved over the
    window. Any nonzero rate pages — shedding is correct behavior
    under overload, but an operator must know capacity is being
    exceeded while it happens. Edge-triggered like every rule: one
    incident per shedding episode (the flight record stamps the worst
    RECENT queue-wait exemplar's trace — the concrete request class
    that was waiting while sheds ran), resolved when sheds stop."""

    name = "shed.rate"
    severity = "page"

    def evaluate(self, ctx):
        rate = ctx["rates"].get("serving.shed", 0.0)
        if rate <= 0.0:
            return False, {}
        return True, {
            "value": round(rate, 3),
            "trace_id": _worst_exemplar(ctx["snap"],
                                        "serving.queue_wait_us",
                                        _exemplar_age(ctx)),
            "detail": (f"shedding {rate:.2f} req/s over "
                       f"{ctx['dt']:.1f}s — demand exceeds capacity, "
                       "low-priority traffic is being dropped")}


def default_rules():
    return [
        BurnRateRule("slo.ttft_burn", "serving.ttft_us",
                     "FLAGS_slo_ttft_budget_us"),
        BurnRateRule("slo.itl_burn", "serving.itl_us",
                     "FLAGS_slo_itl_budget_us"),
        QueueGrowthRule(),
        StallRule(),
        ShedRateRule(),
    ]


class AlertManager:
    """Edge-triggered rule evaluation and incident store. Thread-safe.

    Rules read the process-global ``serving.*`` registry family, so with
    several engines in one process the incidents describe the process
    aggregate, not one engine. One manager per engine exists so each
    engine's scheduler and endpoint have something to nudge and serve.
    The scheduler nudges ``maybe_evaluate`` each step; ``/alerts``
    serves ``as_dict()``."""

    def __init__(self, rules=None, history_cap=256):
        self.rules = list(rules) if rules is not None else default_rules()
        self._delta = _export.DeltaRates("serving.", include_buckets=True)
        self._active = {}             # rule name -> incident dict
        self._history = deque(maxlen=history_cap)
        self._last = None             # monotonic ts of last evaluation
        self._lock = threading.Lock()

    def maybe_evaluate(self):
        """Evaluate iff at least ``FLAGS_alert_interval_s`` elapsed
        since the previous evaluation (the per-step nudge: one clock
        read + compare when it's not time yet). The interval re-checks
        UNDER the lock — two racing nudges (a /alerts GET + a scheduler
        step) must not produce a near-zero window whose empty rates
        would spuriously resolve active incidents. The nudge acquires
        the lock NON-blocking: concurrent scrapers polling /alerts must
        not convoy behind one evaluation and each pay — whoever loses the
        race skips, the winner's evaluation covered the window."""
        interval = float(flags_mod.flag("FLAGS_alert_interval_s"))
        last = self._last
        if last is not None and time.monotonic() - last < interval:
            return []  # cheap unlocked fast path (per-step cost)
        if not self._lock.acquire(blocking=False):
            return []  # a concurrent nudge is already evaluating
        try:
            return self._evaluate_locked(min_interval=interval)
        finally:
            self._lock.release()

    def evaluate(self, min_interval=0.0):
        """Run every rule over the window since the last evaluation.
        Returns the incidents that NEWLY fired (empty on the priming
        call, while incidents merely stay active, and when
        ``min_interval`` has not elapsed — the race-free rate limit)."""
        with self._lock:
            return self._evaluate_locked(min_interval)

    def _evaluate_locked(self, min_interval=0.0):
        now = time.monotonic()
        dt = (now - self._last) if self._last is not None else 0.0
        if min_interval and self._last is not None \
                and dt < min_interval:
            return []  # lost the race to a concurrent evaluation
        rates = self._delta.rates()
        self._last = now
        _c_evals.inc()  # an actual window consumed (incl. priming)
        if not rates:
            return []  # priming call: no window to judge yet
        snap = _metrics.snapshot("serving.")
        ctx = {"rates": rates, "snap": snap, "dt": dt}
        fired = []
        for rule in self.rules:
            try:
                firing, info = rule.evaluate(ctx)
            except Exception:  # noqa: BLE001 - a broken rule must not kill serving
                _c_errors.inc()
                firing, info = False, {}
            active = self._active.get(rule.name)
            if firing and active is None:
                inc = {"rule": rule.name, "severity": rule.severity,
                       "since": time.time(), "count": 1, **info}
                self._active[rule.name] = inc
                fired.append(inc)
                _c_fired.inc()
                self._record(inc)
            elif firing:
                active.update(info)
                active["count"] += 1
            elif active is not None:
                active["resolved"] = time.time()
                self._history.append(active)
                del self._active[rule.name]
                _c_resolved.inc()
        return fired

    @staticmethod
    def _record(inc):
        """Flight-record the incident (once, at the firing edge),
        stamped with the offender trace_id where the rule found one."""
        try:
            from ..distributed import watchdog
        except Exception:  # noqa: BLE001 — alerting must never break serving
            return
        meta = {k: v for k, v in inc.items()
                if k in ("severity", "value", "threshold", "detail")}
        ctx = {"trace_id": inc["trace_id"]} if inc.get("trace_id") \
            else None
        with _tracing.attach(ctx):
            watchdog.record_event(f"alert.{inc['rule']}", meta=meta,
                                  status="alert")

    def active(self):
        with self._lock:
            return [dict(i) for i in self._active.values()]

    def history(self):
        with self._lock:
            return [dict(i) for i in self._history]

    def as_dict(self):
        """The /alerts endpoint body."""
        with self._lock:
            return {"active": [dict(i) for i in self._active.values()],
                    "history": [dict(i) for i in self._history],
                    "rules": [{"name": r.name, "severity": r.severity}
                              for r in self.rules],
                    "window_s": float(flags_mod.flag(
                        "FLAGS_alert_interval_s"))}
