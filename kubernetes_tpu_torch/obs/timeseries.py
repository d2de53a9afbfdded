"""Windowed time-series telemetry: the steady-state view.

The counterpart of `kubernetes_tpu/obs/timeseries.py`. The flight recorder,
the SLO gates and the pod tracer aggregate over a WHOLE run, blind to a
control plane that runs forever under churn: a slow heap pin or a leaked
bind-worker debt moves no end-of-run p99, but is a straight line on a
per-window chart. This module is that chart.

  TimeSeriesRecorder — fixed-interval windows (default 5s) over the batch
      pipeline, ring-bounded. ONE tap per batch (never per pod):
      note_batch() folds the batch's StageClock map + counts into the
      OPEN window; when a batch (or a read) lands past the window end the
      window CLOSES — per-stage p50/p99 settle by nearest-rank over the
      window's per-batch samples (bounded by batches/window), probes fire
      ONCE (queue depth, breaker state, watch lag, partition counters,
      resource-sampler columns, and the "alloc" probe's
      pod_obj_allocs gauge: per-window pod-object materializations summed
      across the store and scheduler-cache columnar tables, 0 at the
      end-to-end columnar steady state), and the closed dict joins the ring.
      Measured settle/tap self-time accrues to stat_sink (the flight
      recorder's <2% instrumentation budget covers this layer too).

  fit_slope / drift_ratio — the trend math the leak/regression gates in
      scheduler/slo.py consume: least-squares slope over (t, value) points
      (RSS MB/min, live-object blocks/s) and a last-third vs first-third
      drift ratio for "is the p99 creeping" without modeling the noise.

Each closed window is a labeled (load, latency, resource) snapshot at a
fixed cadence.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .recorder import nearest_rank

# how many closed windows the ring keeps (default: 20 min of 5s windows)
DEFAULT_CAPACITY = 240
DEFAULT_WINDOW_S = 5.0


def extract_series(windows: List[Dict], *path: str
                   ) -> List[Tuple[float, float]]:
    """[(window end_ts, value)] for one dotted path across window records
    (e.g. ("stages", "solve", "p99_ms") or ("resource", "rss_mb")) — the
    shared feed of TimeSeriesRecorder.series() and the slo.py trend gates.
    Windows missing the path are skipped (honest gaps, not zeros)."""
    out = []
    for rec in windows:
        node = rec
        for p in path:
            if not isinstance(node, dict) or p not in node:
                node = None
                break
            node = node[p]
        if isinstance(node, (int, float)):
            out.append((rec.get("end_ts", 0.0), float(node)))
    return out


def fit_slope(points: List[Tuple[float, float]]) -> Optional[float]:
    """Least-squares slope (units/second) over (t, value) points; None with
    fewer than 2 distinct timestamps. Plain closed-form fit — the gates need
    'is this line going up', not a model of the noise."""
    if len(points) < 2:
        return None
    n = float(len(points))
    sx = sum(p[0] for p in points)
    sy = sum(p[1] for p in points)
    sxx = sum(p[0] * p[0] for p in points)
    sxy = sum(p[0] * p[1] for p in points)
    denom = n * sxx - sx * sx
    if denom <= 0.0:
        return None  # all samples share one timestamp
    return (n * sxy - sx * sy) / denom


def drift_ratio(values: List[float]) -> Optional[float]:
    """Median of the last third over median of the first third — the 'is
    the tail creeping up under steady load' detector. A flat series reads
    ~1.0; monotonic growth reads >1. Medians, not means: one co-scheduling
    stall in either third must not fake (or mask) a drift verdict — a real
    leak raises the median too. None under 3 samples or a zero/negative
    first-third median (ratio would be meaningless)."""
    if len(values) < 3:
        return None
    third = max(1, len(values) // 3)

    def med(vs: List[float]) -> float:
        s = sorted(vs)
        return s[len(s) // 2]

    h = med(values[:third])
    if h <= 0.0:
        return None
    return med(values[-third:]) / h


class _OpenWindow:
    """Accumulator for the window currently filling (private to the
    recorder; all access under its lock)."""

    __slots__ = ("start", "end", "stage_samples", "stage_totals", "batches",
                 "pods", "scheduled", "failed")

    def __init__(self, start: float, end: float):
        self.start = start
        self.end = end
        # per-stage per-batch seconds — bounded by batches/window, the
        # nearest-rank source for the window's p50/p99 at close
        self.stage_samples: Dict[str, List[float]] = {}
        self.stage_totals: Dict[str, float] = {}
        self.batches = 0
        self.pods = 0
        self.scheduled = 0
        self.failed = 0


class TimeSeriesRecorder:
    """Ring of closed fixed-interval windows over the batch pipeline.

    Write side: note_batch() once per schedule_batch (O(stages), never per
    pod). Read side: windows() / series() close an expired open window
    first, so an idle scheduler's last window still settles. Probes are
    callables fired once per window CLOSE returning a flat dict merged into
    the window record — the place queue depth, breaker state, watch lag and
    sampler columns enter without the hot path paying for them per batch.
    """

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 capacity: int = DEFAULT_CAPACITY, enabled: bool = True,
                 stat_sink=None):
        self.window_s = float(window_s)
        self.capacity = capacity
        self.enabled = enabled
        self.stat_sink = stat_sink  # FlightRecorder: self-time budget
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._open: Optional[_OpenWindow] = None
        self._probes: List[Tuple[str, Callable[[], Optional[Dict]]]] = []
        self._seq = 0
        self.windows_closed = 0
        self._self_s = 0.0

    # -- configuration ---------------------------------------------------------

    def add_probe(self, name: str, fn: Callable[[], Optional[Dict]]) -> None:
        """Register a window-close probe. fn() returns a flat dict merged
        into every closed window (or None to contribute nothing); it runs
        once per window, off the per-batch path, and an exception skips the
        probe rather than losing the window."""
        with self._lock:
            self._probes.append((name, fn))

    # -- write side ------------------------------------------------------------

    def note_batch(self, stages: Dict[str, float], pods: int = 0,
                   scheduled: int = 0, failed: int = 0,
                   now: Optional[float] = None) -> None:
        """Fold ONE batch into the open window (stage values in SECONDS —
        the StageClock map). The single hot-path tap: everything else this
        module does runs at window close or read time."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        now = t0 if now is None else now
        with self._lock:
            w = self._advance_locked(now)
            w.batches += 1
            w.pods += pods
            w.scheduled += scheduled
            w.failed += failed
            for name, sec in stages.items():
                w.stage_samples.setdefault(name, []).append(sec)
                w.stage_totals[name] = w.stage_totals.get(name, 0.0) + sec
        self._bill(time.perf_counter() - t0)

    def note_stage(self, name: str, seconds: float,
                   now: Optional[float] = None) -> None:
        """Fold one outside-bucket observation (bind worker wall, bind_wait
        stall, bulk queue_add) into the open window — the RingRecorder
        add_outside forwarding path. O(1), callable from the bind worker
        thread (the lock is the only shared state)."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        now = t0 if now is None else now
        with self._lock:
            w = self._advance_locked(now)
            w.stage_samples.setdefault(name, []).append(seconds)
            w.stage_totals[name] = w.stage_totals.get(name, 0.0) + seconds
        self._bill(time.perf_counter() - t0)

    def _bill(self, seconds: float) -> None:
        # under the lock: note_stage runs on the bind worker concurrently
        # with note_batch on the scheduling thread
        with self._lock:
            self._self_s += seconds
        sink = self.stat_sink
        if sink is not None:
            sink.note_self_time(seconds)

    def _advance_locked(self, now: float) -> _OpenWindow:
        """Close any expired open window and return the one covering `now`
        (caller holds self._lock). A long idle gap closes the single stale
        window and opens one fresh window at the current boundary — no
        fabricated empty windows in between (slope fits use real
        timestamps, so gaps are honest)."""
        w = self._open
        if w is not None and now < w.end:
            return w
        if w is not None:
            self._close_locked(w)
        # contiguous load: the next window abuts the closed one; after an
        # idle gap (or at birth) a fresh epoch starts AT `now` — either way
        # the new window covers `now`
        if w is None or now - w.end >= self.window_s:
            start = now
        else:
            start = w.end
        self._open = _OpenWindow(start, start + self.window_s)
        return self._open

    def _close_locked(self, w: _OpenWindow) -> None:
        """Settle one window into the ring (caller holds self._lock): per-
        stage nearest-rank p50/p99 over the window's per-batch samples plus
        one probe sweep. Cost is O(stages x batches-in-window log) once per
        window_s — never on the per-pod path."""
        self._seq += 1
        self.windows_closed += 1
        stages: Dict[str, Dict] = {}
        for name, samples in w.stage_samples.items():
            samples.sort()
            tot = w.stage_totals.get(name, 0.0)
            stages[name] = {
                "total_ms": round(tot * 1000, 3),
                "p50_ms": round(nearest_rank(samples, 0.50) * 1000, 3),
                "p99_ms": round(nearest_rank(samples, 0.99) * 1000, 3),
                "batches": len(samples),
            }
        span = max(w.end - w.start, 1e-9)
        rec = {
            "seq": self._seq,
            # start/end ride the perf_counter domain (slope math needs the
            # monotonic axis); ts is the wall clock for remote rendering
            "ts": round(time.time(), 3),
            # cumulative recorder self-time at close — consecutive windows
            # difference to "instrumentation paid THIS window" (self-time
            # measured and published per window)
            "self_s": round(self._self_s, 6),
            "start_ts": round(w.start, 6),
            "end_ts": round(w.end, 6),
            "window_s": round(self.window_s, 3),
            "batches": w.batches,
            "pods": w.pods,
            "scheduled": w.scheduled,
            "failed": w.failed,
            "pods_per_sec": round(w.scheduled / span, 1),
            "stages": stages,
        }
        for name, fn in self._probes:
            try:
                got = fn()
            except Exception:
                continue  # a wedged probe must not lose the window
            if got:
                rec[name] = got
        self._ring.append(rec)

    # -- read side -------------------------------------------------------------

    def windows(self, last: Optional[int] = None) -> List[Dict]:
        """Closed windows, oldest first (the ring's bound). Settles an
        expired open window first so an idle tail still rolls."""
        if not self.enabled:
            return []
        t0 = time.perf_counter()
        with self._lock:
            w = self._open
            if w is not None and t0 >= w.end:
                self._close_locked(w)
                self._open = None
            out = list(self._ring)
        self._bill(time.perf_counter() - t0)
        return out[-last:] if last else out

    def series(self, *path: str, last: Optional[int] = None
               ) -> List[Tuple[float, float]]:
        """extract_series over this recorder's closed windows — what the
        slope/drift gates consume live."""
        return extract_series(self.windows(last=last), *path)

    @property
    def self_seconds(self) -> float:
        return self._self_s

    def clear(self) -> None:
        """Drop every window AND the open accumulator: the warmup-exclusion
        idiom (flightrec.clear() sibling)."""
        with self._lock:
            self._ring.clear()
            self._open = None
            self._seq = 0
            self.windows_closed = 0
            self._self_s = 0.0
