"""Deadlines and degradation records (mirrors the part of
``paddle_tpu/core/resilience.py`` the serving frontend calls).

- ``Deadline``: an absolute time budget on the monotonic clock; the
  serving scheduler sweeps ``expired()`` at step boundaries and the
  overload controller reads ``remaining()``.
- ``degrade(domain)``: records that a fallback path ran, as the
  ``resilience.degrade.<domain>`` counter of the metrics registry. The
  reference also appends a flight record (the detail, the error) to its
  watchdog ring, which the port does not have.

Not ported: retry policies, leases and circuit breakers.
"""

from __future__ import annotations

import time

from ..profiler import metrics as _metrics

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


def degrade(domain):
    """A fallback path ran: count ``resilience.degrade.<domain>``."""
    _metrics.counter(f"resilience.degrade.{domain}").inc()
