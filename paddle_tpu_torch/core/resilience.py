"""Deadlines and degradation records (mirrors the part of
``paddle_tpu/core/resilience.py`` the serving frontend calls).

- ``Deadline``: an absolute time budget on the monotonic clock; the
  serving scheduler sweeps ``expired()`` at step boundaries and the
  overload controller reads ``remaining()``.
- ``degrade(domain, detail, exc)``: records that a fallback path ran, as
  the ``resilience.degrade.<domain>`` counter of the metrics registry and
  a ``degrade/<domain>`` record in the flight ring
  (``distributed/watchdog.py``), stamped with the active trace id.

Not ported: retry policies, leases and circuit breakers.
"""

from __future__ import annotations

import time

from ..profiler import metrics as _metrics
from ..profiler import tracing as _tracing

__all__ = ["Deadline", "degrade"]


class Deadline:
    """Absolute time budget on the monotonic clock. A request without a
    deadline carries ``None`` (callers test ``deadline is not None``)."""

    __slots__ = ("expires_at",)

    def __init__(self, seconds):
        self.expires_at = time.monotonic() + float(seconds)

    @classmethod
    def after(cls, seconds):
        return cls(seconds)

    def expired(self):
        return time.monotonic() >= self.expires_at

    def remaining(self):
        return max(0.0, self.expires_at - time.monotonic())

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


def degrade(domain, detail=None, exc=None):
    """A fallback path ran: count ``resilience.degrade.<domain>`` and
    append a ``degrade/<domain>`` flight record (the detail, the error,
    the active trace id). Never raises: the degraded path is already
    handling a failure."""
    _metrics.counter(f"resilience.degrade.{domain}").inc()
    meta = {}
    if detail:
        meta["detail"] = str(detail)
    if exc is not None:
        meta["error"] = f"{type(exc).__name__}: {exc}"
    tid = _tracing.current_trace_id()
    if tid is not None:
        meta["trace"] = tid
    try:
        from ..distributed import watchdog
        watchdog.record_event(f"degrade/{domain}", meta or None,
                              status="degraded")
    except Exception:  # noqa: BLE001 - telemetry must not mask recovery
        pass
