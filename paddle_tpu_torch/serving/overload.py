"""Overload control: deadline-aware admission, priority load shedding
and a brownout ladder over the serving scheduler (mirrors
``paddle_tpu/serving/overload.py``).

- **Deadline-aware admission** (``FLAGS_serving_admission``). A
  :class:`ServiceTimeModel` keeps EWMAs of the per-token prefill cost and
  the per-step decode cost, observed at each dispatch on the host clock
  (the prefill's sampled token is read back with ``int()``, which waits
  for the device). At ``submit()`` it predicts queue wait + TTFT; a
  request whose ``deadline_s`` cannot be met even at
  ``FLAGS_admission_optimism`` times the prediction is rejected at once
  with :class:`AdmissionRejected` and a ``retry_after_s``. The model
  rejects only once primed (a few observed prefills).
- **Priority load shedding** (same flag). ``submit(priority=)`` takes an
  int class, smaller is more important (:data:`HIGH` 0, :data:`NORMAL` 1
  the default, :data:`LOW` 2). Each step the controller computes a
  pressure (the max of queue depth against ``FLAGS_shed_queue_frac`` x
  max_queue, KV occupancy against ``FLAGS_shed_kv_frac`` and predicted
  queue wait against ``FLAGS_shed_wait_s``; 0 while fewer than
  ``FLAGS_shed_min_queue`` requests queue). At pressure >= 1 the
  scheduler sheds the lowest-priority, newest queued requests to the
  terminal status ``SHED``; the top class is never shed.
- **Brownout ladder** (``FLAGS_serving_brownout``). Under sustained
  pressure an edge-triggered controller with hysteresis walks stage 1
  (clamp ``max_new_tokens`` to ``FLAGS_brownout_clamp_tokens``), 2
  (reject below-NORMAL submits) and 3 (admit only the top class),
  entering after ``FLAGS_brownout_enter_steps`` over-pressure steps and
  leaving after ``FLAGS_brownout_exit_steps`` steps at or below
  ``FLAGS_brownout_exit_pressure``; the ``serving.brownout.stage`` gauge
  shows the rung.

Both flags are read when a Scheduler is built; with both off it holds
:data:`NULL`, whose every hook is a no-op.
"""

from __future__ import annotations

from ..core import flags as flags_mod
from ..core import resilience
from ..profiler import metrics as _metrics

__all__ = ["AdmissionRejected", "ServiceTimeModel", "BrownoutController",
           "OverloadController", "NULL", "HIGH", "NORMAL", "LOW"]

# priority classes: smaller = more important (any int is accepted; these
# are the rungs the brownout ladder gates against)
HIGH = 0
NORMAL = 1
LOW = 2

_US_BOUNDS = (500, 1000, 2500, 5000, 10000, 25000, 50000, 100000,
              250000, 500000, 1000000, 5000000)
_m_adm_rejected = _metrics.counter("serving.admission.rejected")
_m_clamped = _metrics.counter("serving.brownout.clamped")
_m_transitions = _metrics.counter("serving.brownout.transitions")
_g_stage = _metrics.gauge("serving.brownout.stage")
_h_pred_ttft = _metrics.histogram("admission.predicted_ttft_us",
                                  bounds=_US_BOUNDS)


class AdmissionRejected(RuntimeError):
    """Submission refused by the overload control, before any queueing
    or prefill. ``reason`` is ``"deadline"`` (the model proved the
    deadline unmeetable) or ``"brownout"`` (the ladder's stage refuses
    this priority); ``retry_after_s`` estimates when a retry could be
    admitted (None while the model is unprimed)."""

    def __init__(self, message, *, reason, retry_after_s=None,
                 predicted_ttft_s=None, deadline_s=None,
                 queue_depth=None, priority=None, stage=None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.predicted_ttft_s = predicted_ttft_s
        self.deadline_s = deadline_s
        self.queue_depth = queue_depth
        self.priority = priority
        self.stage = stage


class ServiceTimeModel:
    """EWMA service-time model: per-token prefill cost and per-step
    decode cost. Predictions are a drain-time estimate, and admission
    scales them by ``FLAGS_admission_optimism`` before trusting them."""

    __slots__ = ("alpha", "min_samples", "prefill_us_per_token",
                 "decode_step_us", "n_prefill", "n_decode")

    def __init__(self, alpha=0.2, min_samples=3):
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.prefill_us_per_token = None
        self.decode_step_us = None
        self.n_prefill = 0
        self.n_decode = 0

    @property
    def primed(self):
        """Enough observations to base a rejection on."""
        return self.n_prefill >= self.min_samples

    def _ewma(self, old, sample):
        return sample if old is None else \
            old + self.alpha * (sample - old)

    def observe_prefill(self, tokens, us):
        """One prefill computed ``tokens`` (padded) in ``us``."""
        rate = float(us) / max(int(tokens), 1)
        self.prefill_us_per_token = \
            self._ewma(self.prefill_us_per_token, rate)
        self.n_prefill += 1

    def observe_decode(self, us):
        """One batched decode step took ``us``."""
        self.decode_step_us = self._ewma(self.decode_step_us, float(us))
        self.n_decode += 1

    def predict(self, queued_tokens, queued_requests, own_tokens):
        """(predicted queue wait us, predicted TTFT us) for a request
        behind ``queued_requests`` requests of ``queued_tokens``
        uncovered prefill tokens, itself needing ``own_tokens``: everyone
        ahead's prefill plus one interleaved decode step per queued
        request; TTFT adds its own prefill and one decode step."""
        ppt = self.prefill_us_per_token or 0.0
        step = self.decode_step_us or 0.0
        wait_us = queued_tokens * ppt + queued_requests * step
        ttft_us = wait_us + max(own_tokens, 1) * ppt + step
        return wait_us, ttft_us


class BrownoutController:
    """The degradation ladder: stage 0 (normal) .. 3 (top priority only).
    Escalation needs ``enter_steps`` consecutive updates at pressure >=
    1, de-escalation ``exit_steps`` consecutive updates at or below
    ``exit_pressure``; the band between holds the stage and restarts
    both windows. Each transition sets ``serving.brownout.stage`` and
    counts ``serving.brownout.transitions``."""

    MAX_STAGE = 3

    __slots__ = ("enter_steps", "exit_steps", "exit_pressure", "stage",
                 "_over", "_under")

    def __init__(self, enter_steps=None, exit_steps=None,
                 exit_pressure=None):
        self.enter_steps = (
            int(flags_mod.flag("FLAGS_brownout_enter_steps"))
            if enter_steps is None else int(enter_steps))
        self.exit_steps = (
            int(flags_mod.flag("FLAGS_brownout_exit_steps"))
            if exit_steps is None else int(exit_steps))
        self.exit_pressure = (
            float(flags_mod.flag("FLAGS_brownout_exit_pressure"))
            if exit_pressure is None else float(exit_pressure))
        self.stage = 0
        self._over = 0
        self._under = 0

    def update(self, pressure):
        """One evaluation (once per scheduler step); returns the stage."""
        if pressure >= 1.0:
            self._under = 0
            self._over += 1
            if self._over >= self.enter_steps \
                    and self.stage < self.MAX_STAGE:
                self._transition(self.stage + 1)
                self._over = 0
        elif pressure <= self.exit_pressure:
            self._over = 0
            self._under += 1
            if self._under >= self.exit_steps and self.stage > 0:
                self._transition(self.stage - 1)
                self._under = 0
        else:
            self._over = 0
            self._under = 0
        return self.stage

    def _transition(self, to):
        self.stage = to
        _g_stage.set(to)
        _m_transitions.inc()


class OverloadController:
    """Per-scheduler control: owns the service-time model, the pressure,
    the shed policy and (optionally) the brownout ladder. The scheduler
    drives it: ``observe_*`` at each dispatch, ``control`` once per step
    before admission, ``admit`` at each submit. Not thread-safe by
    itself; the frontend's engine lock serializes."""

    def __init__(self, admission=True, brownout=True, model=None):
        self.shedding = bool(admission)
        self.model = model if model is not None else ServiceTimeModel()
        self.optimism = float(flags_mod.flag("FLAGS_admission_optimism"))
        self.min_queue = int(flags_mod.flag("FLAGS_shed_min_queue"))
        self.queue_frac = float(flags_mod.flag("FLAGS_shed_queue_frac"))
        self.kv_frac = float(flags_mod.flag("FLAGS_shed_kv_frac"))
        self.wait_s = float(flags_mod.flag("FLAGS_shed_wait_s"))
        self.clamp_tokens = int(
            flags_mod.flag("FLAGS_brownout_clamp_tokens"))
        self.brownout = BrownoutController() if brownout else None

    # -- scheduler hooks ---------------------------------------------------

    def observe_prefill(self, tokens, us):
        self.model.observe_prefill(tokens, us)

    def observe_decode(self, us):
        self.model.observe_decode(us)

    def estimate_tokens(self, sched, prompt):
        """Tokens this prompt will compute at prefill: the prefix plan's
        uncovered tail when caching is on (``plan_prefix`` has no side
        effects)."""
        if sched.prefix_cache:
            try:
                plan = sched.cache.plan_prefix(prompt)
                return max(len(prompt) - plan.covered_tokens, 1)
            except Exception:  # noqa: BLE001 — an estimate, never a failure
                pass
        return max(len(prompt), 1)

    def _queued_tokens(self, sched):
        return sum(r.est_tokens for r in sched.queue)

    def queue_retry_after(self, sched):
        """Predicted seconds until the queue drains: the
        ``retry_after_s`` of sheds and rejections. None until primed."""
        if not self.model.primed:
            return None
        wait_us, _ = self.model.predict(self._queued_tokens(sched),
                                        len(sched.queue), 0)
        return max(wait_us / 1e6, 0.001)

    def admit(self, sched, prompt, max_new_tokens, deadline, priority):
        """The submit-time gate. Returns ``(est_tokens,
        effective_max_new_tokens)`` or raises :class:`AdmissionRejected`
        (the brownout priority floor, or an unmeetable deadline). A
        failing prediction fails open."""
        stage = self.brownout.stage if self.brownout is not None else 0
        if stage >= 1 and self.clamp_tokens \
                and max_new_tokens > self.clamp_tokens:
            max_new_tokens = self.clamp_tokens
            _m_clamped.inc()
        est = self.estimate_tokens(sched, prompt)
        wait_us = ttft_us = None
        if self.shedding:
            try:
                wait_us, ttft_us = self.model.predict(
                    self._queued_tokens(sched), len(sched.queue), est)
                _h_pred_ttft.observe(ttft_us)
            except Exception:  # noqa: BLE001 — fail open
                resilience.degrade("serving.admission")
                wait_us = ttft_us = None
        floor = HIGH if stage >= 3 else (NORMAL if stage >= 2 else None)
        if floor is not None and priority > floor:
            _m_adm_rejected.inc()
            raise AdmissionRejected(
                f"serving.submit: brownout stage {stage} admits only "
                f"priority <= {floor} (got {priority})",
                reason="brownout", stage=stage, priority=priority,
                queue_depth=len(sched.queue),
                retry_after_s=None if wait_us is None
                else max(wait_us / 1e6, 0.001))
        if deadline is not None and ttft_us is not None \
                and self.model.primed:
            remaining = deadline.remaining()
            predicted_s = ttft_us / 1e6
            if predicted_s * self.optimism > remaining:
                _m_adm_rejected.inc()
                raise AdmissionRejected(
                    f"serving.submit: deadline provably unmeetable — "
                    f"predicted TTFT {predicted_s * 1e3:.1f}ms (even "
                    f"x{self.optimism} optimism) exceeds the "
                    f"{remaining * 1e3:.1f}ms remaining",
                    reason="deadline", predicted_ttft_s=predicted_s,
                    deadline_s=remaining, priority=priority,
                    queue_depth=len(sched.queue),
                    retry_after_s=max(wait_us / 1e6,
                                      predicted_s - remaining, 0.001))
        return est, max_new_tokens

    # -- the per-step control loop ----------------------------------------

    def pressure(self, sched):
        """Overload pressure in [0, inf): the max of the normalized
        watermark signals, 0 below the ``FLAGS_shed_min_queue`` backlog.
        >= 1.0 is shed territory."""
        q = len(sched.queue)
        if q < self.min_queue:
            return 0.0
        parts = [0.0]
        if sched.max_queue:
            parts.append(q / max(self.queue_frac * sched.max_queue, 1.0))
        occ = sched.cache.occupancy()
        if occ["usable"]:
            parts.append((occ["active"] / occ["usable"]) / self.kv_frac)
        if self.model.primed:
            wait_us, _ = self.model.predict(self._queued_tokens(sched),
                                            q, 0)
            parts.append((wait_us / 1e6) / self.wait_s)
        return max(parts)

    def _shed_victim(self, queue):
        """Lowest-priority, newest queued request; never the top class,
        and never a preempted request (it already streamed tokens)."""
        victim = None
        for r in queue:
            if r.priority <= HIGH or r.generated:
                continue
            if victim is None \
                    or (r.priority, r.rid) > (victim.priority, victim.rid):
                victim = r
        return victim

    def control(self, sched):
        """One per-step evaluation: compute the pressure, walk the
        brownout ladder, shed queued requests while over pressure.
        Returns the pressure it acted on."""
        p = self.pressure(sched)
        if self.brownout is not None:
            self.brownout.update(p)
        if not self.shedding:
            return p
        while p >= 1.0 and sched.queue:
            victim = self._shed_victim(sched.queue)
            if victim is None:
                break
            sched.shed(victim,
                       retry_after_s=self.queue_retry_after(sched))
            p = self.pressure(sched)
        return p


class _NullOverload(OverloadController):
    """Disarmed control: every scheduler hook a no-op."""

    shedding = False
    brownout = None

    def __init__(self):  # no flag reads, no model
        pass

    def observe_prefill(self, tokens, us):
        pass

    def observe_decode(self, us):
        pass

    def admit(self, sched, prompt, max_new_tokens, deadline, priority):
        return 0, max_new_tokens

    def control(self, sched):
        return 0.0

    def queue_retry_after(self, sched):
        return None


NULL = _NullOverload()
