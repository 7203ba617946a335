"""The flight recorder (mirrors the ring of
``paddle_tpu/distributed/watchdog.py``: ``FlightRecorder`` :53,
``flight_recorder`` :209, ``record_event`` :219).

A ring of recent point-in-time records: degradations
(``core.resilience.degrade`` appends ``degrade/<domain>``) and alert
incidents (``profiler/alerts.py`` appends ``alert.<rule>`` at each firing
edge). A record made while a request trace is active carries its trace
id, so the "Recent incidents" summary view (``profiler.summary_text``)
links each event back to the request in flight.

Not ported: the ``CollectiveWatchdog`` that supervises steps and its
heartbeats, which wait for the distributed slice; so the ring here is
always the standalone module ring.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque

__all__ = ["FlightRecorder", "flight_recorder", "record_event"]


def _active_trace_id():
    """The ambient request trace id (``profiler/tracing.py``), or None.
    Imported late: the profiler package imports this module's users."""
    try:
        from ..profiler import tracing
    except Exception:  # noqa: BLE001 - a telemetry probe, never fatal
        return None
    return tracing.current_trace_id()


class FlightRecorder:
    """Ring buffer of recent records, each stamped with the active trace
    id when one exists."""

    def __init__(self, capacity=64):
        self._buf = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def start(self, tag, meta=None):
        tid = _active_trace_id()
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "tag": tag, "start": time.time(),
                   "end": None, "status": "running", **(meta or {})}
            if tid is not None and "trace" not in rec:
                rec["trace"] = tid
            self._buf.append(rec)
            return rec

    def finish(self, rec, status="done"):
        with self._lock:
            rec["end"] = time.time()
            rec["status"] = status

    def records(self):
        with self._lock:
            return [dict(r) for r in self._buf]

    def dump(self, file=None):
        out = file or sys.stderr
        now = time.time()
        for r in self.records():
            dur = (r["end"] or now) - r["start"]
            meta = {k: v for k, v in r.items()
                    if k not in ("seq", "tag", "start", "end", "status")}
            print(f"  [flight {r['seq']}] {r['tag']}: {r['status']} "
                  f"{dur:.1f}s" + (f" meta={json.dumps(meta)}" if meta
                                   else ""), file=out)


# the process's ring: degradations and incidents always land somewhere
_standalone_recorder = FlightRecorder(capacity=128)


def flight_recorder():
    """The process's flight recorder."""
    return _standalone_recorder


def record_event(tag, meta=None, status="degraded"):
    """Append a point-in-time (already finished) record; ``status``
    labels it in dumps and in the summary view."""
    rec = flight_recorder().start(tag, meta)
    flight_recorder().finish(rec, status)
    return rec
