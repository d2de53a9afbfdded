"""Trace-event ring: the hook the rebalancer and the fault injector tap.

The counterpart of `kubernetes_tpu/obs/tracebuf.py`, lean. A TraceBuffer is
a bounded ring of Chrome trace-event dicts (name/cat/ph/ts/pid/tid, ts in
MICROseconds from the buffer's creation), one track (tid) per name:

  X  complete slice (note_span)  — a rebalance cycle
  i  instant (instant)           — a rebalance wave boundary, a FaultInject
                                   firing
  C  counter (counter)           — one sample of named series

Disabled cost is ONE module-attribute check: every site guards with
``if tracebuf.ACTIVE is not None:``, exactly like chaos/faultinject.py.
Armed, every tap adds its own perf_counter time to self_seconds.

Not in this module yet (ROADMAP.md queue 1 item 7, with the flight recorder
and pod traces that feed them): the per-batch envelope (note_batch), the
scheduler-clock anchor (attach_clock), the Chrome export with its
evict->replace flow arrows (export), disabled_check_cost_ns and
validate_export. The ring holds the same events the JAX package's does, so
they export once those land.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["TraceBuffer", "ACTIVE", "LAST", "arm", "disarm", "enabled", "current", "status"]

DEFAULT_CAPACITY = 65536
_PID = 1  # single-process orchestrator: one trace process, many tracks


class TraceBuffer:
    """Bounded ring of trace events with per-track (tid) bookkeeping.

    One lock acquisition per tap; a full ring drops the OLDEST event per
    append (deque maxlen) and counts the drop."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._tids: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self.events_total = 0
        self.dropped_total = 0
        self.self_seconds = 0.0

    def _ts(self, t_perf: float) -> float:
        return (t_perf - self._t0) * 1e6  # µs

    def _tid_locked(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
        return tid

    def _push(self, track: str, ev: Dict) -> None:
        with self._lock:
            ev["tid"] = self._tid_locked(track)
            if len(self._ring) == self.capacity:
                self.dropped_total += 1
            self._ring.append(ev)
            self.events_total += 1

    def events(self):
        """A copy of the ring, oldest first (the read surface until the
        Chrome export lands)."""
        with self._lock:
            return list(self._ring)

    # -- taps (one call per cycle / wave / fire) -------------------------------

    def note_span(self, track: str, name: str, t_begin: float, t_end: float,
                  cat: str = "span", args: Optional[Dict] = None) -> None:
        """One complete slice (X), e.g. a rebalance cycle. Timestamps are
        perf_counter values."""
        t0 = time.perf_counter()
        ev = {"name": name, "cat": cat, "ph": "X", "ts": self._ts(t_begin),
              "dur": round(max(t_end - t_begin, 0.0) * 1e6, 3), "pid": _PID}
        if args:
            ev["args"] = args
        self._push(track, ev)
        self.self_seconds += time.perf_counter() - t0

    def instant(self, track: str, name: str, cat: str = "event",
                t: Optional[float] = None, args: Optional[Dict] = None,
                scope: str = "t") -> None:
        """One instant event (i): a FaultInject firing, a rebalance wave
        boundary."""
        t0 = time.perf_counter()
        ev = {"name": name, "cat": cat, "ph": "i", "s": scope,
              "ts": self._ts(t if t is not None else t0), "pid": _PID}
        if args:
            ev["args"] = args
        self._push(track, ev)
        self.self_seconds += time.perf_counter() - t0

    def counter(self, track: str, name: str, values: Dict[str, float],
                t: Optional[float] = None) -> None:
        """One counter sample (C): `values` maps series name -> value."""
        t0 = time.perf_counter()
        ev = {"name": name, "cat": "counter", "ph": "C",
              "ts": self._ts(t if t is not None else t0), "pid": _PID,
              "args": dict(values)}
        self._push(track, ev)
        self.self_seconds += time.perf_counter() - t0

    def status(self) -> Dict:
        with self._lock:
            return {
                "armed": ACTIVE is self,
                "capacity": self.capacity,
                "trace_events_total": self.events_total,
                "trace_events_dropped_total": self.dropped_total,
                "tracks": len(self._tids),
                "self_seconds": round(self.self_seconds, 6),
            }


# THE hot-path flag: None when disabled. Every instrumented site guards with
# `if tracebuf.ACTIVE is not None:` — one attribute load, no call.
ACTIVE: Optional[TraceBuffer] = None
# The last disarmed buffer: a finished capture stays readable after disarm().
LAST: Optional[TraceBuffer] = None


def arm(capacity: int = DEFAULT_CAPACITY) -> TraceBuffer:
    """Install a fresh trace buffer (replacing any armed one), return it."""
    global ACTIVE
    ACTIVE = TraceBuffer(capacity=capacity)
    return ACTIVE


def disarm() -> Optional[TraceBuffer]:
    """Stop collection; the buffer stays readable as tracebuf.LAST."""
    global ACTIVE, LAST
    buf, ACTIVE = ACTIVE, None
    if buf is not None:
        LAST = buf
    return buf


def enabled() -> bool:
    return ACTIVE is not None


def current() -> Optional[TraceBuffer]:
    """The armed buffer, else the last disarmed one."""
    return ACTIVE if ACTIVE is not None else LAST


def status() -> Dict:
    """Arm/drop counters of the current buffer."""
    buf = current()
    if buf is None:
        return {"armed": False, "trace_events_total": 0,
                "trace_events_dropped_total": 0}
    return buf.status()
