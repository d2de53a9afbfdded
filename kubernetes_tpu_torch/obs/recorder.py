"""Generic ring/stage recorder machinery: the reusable half of the flight
recorder (scheduler/flightrec.py) and of the reconcile recorder.

The counterpart of `kubernetes_tpu/obs/recorder.py`. Design constraints,
binding on every consumer:

  - taps are O(1) per BATCH/loop/chunk, never per pod/key/event in a
    pod-scale loop (the reference's schedlint rule HP001);
  - `time.perf_counter()` is the tap clock (`time.thread_time()` can tick
    at 10ms);
  - everything is bounded: the record ring evicts oldest, the per-stage
    histograms survive eviction at fixed memory;
  - measured self-time accrues to a sink (note_self_time) so the <2%
    instrumentation budget is bounded from a measurement, not by
    differencing two noisy runs.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Windowed per-stage latency buckets: log-spaced 0.2ms..~42s so
# the p50/p99 estimates survive ring eviction at bounded memory. The ~1.55x
# bucket ratio bounds the interpolation error well inside the headroom any
# sane SLO ceiling carries; records still in the ring get EXACT nearest-rank
# percentiles instead (stage_table picks whichever source is lossless).
STAGE_P_BUCKETS = tuple(round(0.0002 * (1.55 ** i), 6) for i in range(28))


def nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Exact nearest-rank percentile over a complete sample."""
    return sorted_vals[min(len(sorted_vals) - 1,
                           max(0, math.ceil(q * len(sorted_vals)) - 1))]


class StageClock:
    """Per-batch stage boundary marks. mark(name) attributes the time since
    the previous boundary; skip() moves the boundary without attributing
    (work another accumulator already claimed)."""

    __slots__ = ("t0", "_last", "stages")

    def __init__(self):
        self.t0 = self._last = time.perf_counter()
        self.stages: Dict[str, float] = {}

    def mark(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self._last = now
        return dt

    def skip(self) -> None:
        self._last = time.perf_counter()

    def add(self, name: str, seconds: float) -> None:
        if seconds > 0:
            self.stages[name] = self.stages.get(name, 0.0) + seconds

    def sub(self, name: str, seconds: float) -> None:
        """Remove sub-stage time another bucket owns (floored at 0)."""
        if seconds > 0 and name in self.stages:
            self.stages[name] = max(0.0, self.stages[name] - seconds)

    def total(self) -> float:
        return time.perf_counter() - self.t0


class RingRecorder:
    """Bounded ring of per-loop/per-batch records plus per-stage aggregate
    state: totals and counts since clear() (survive ring eviction), windowed
    per-stage latency histograms feeding the p50/p99 columns, outside-bucket
    accumulators for work that runs between records, and measured self-time.

    Subclasses (FlightRecorder, ReconcileRecorder) own the record SCHEMA:
    they build their dict and hand it to _append_record with the stage map.
    """

    DEFAULT_CAPACITY = 64

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=capacity)
        self._seq = 0
        # aggregate per-stage seconds since clear(), across ALL records —
        # survives ring eviction so the stage table covers the full window
        self._stage_totals: Dict[str, float] = {}
        self._stage_batches: Dict[str, int] = {}
        # per-stage seconds accrued outside any record (add_outside)
        self._outside: Dict[str, float] = {}
        # per-stage latency histograms: one observation per record (or per
        # outside-bucket call), never evicted with the ring. Built lazily;
        # metrics.Histogram carries its own lock but every write here
        # happens under self._lock anyway.
        self._stage_hist: Dict[str, object] = {}
        # instrumentation self-time: seconds spent building records,
        # observing histograms, and in the timing taps. Divided by wall it
        # bounds the overhead budget from a measurement.
        self._self_s = 0.0
        # optional TimeSeriesRecorder (obs/timeseries.py): when
        # set, per-record stage maps and outside-bucket observations are
        # forwarded so the windowed view covers the overlapped stages
        # (bind, bind_wait, queue_add) the per-batch clock never sees
        self.timeseries = None

    # -- ingest ----------------------------------------------------------------

    def _hist_observe(self, stage: str, seconds: float) -> None:
        """One per-stage latency observation (caller holds self._lock)."""
        h = self._stage_hist.get(stage)
        if h is None:
            from ..server.metrics import Histogram

            h = self._stage_hist[stage] = Histogram(
                stage, buckets=STAGE_P_BUCKETS)
        h.observe(seconds)

    def add_outside(self, stage: str, seconds: float) -> None:
        if not self.enabled or seconds <= 0:
            return
        with self._lock:
            self._outside[stage] = self._outside.get(stage, 0.0) + seconds
            self._hist_observe(stage, seconds)
        ts = self.timeseries
        if ts is not None:
            ts.note_stage(stage, seconds)

    def outside_seconds(self, *stages: str) -> float:
        """Sum of the named outside buckets (the scheduler differences this
        around a pump to keep 'ingest' disjoint from its sub-stages)."""
        with self._lock:
            return sum(self._outside.get(s, 0.0) for s in stages)

    def note_self_time(self, seconds: float) -> None:
        with self._lock:
            self._self_s += seconds

    def _append_record(self, rec: Dict, stages: Dict[str, float]) -> Dict:
        """Ring append + per-stage aggregate updates for one record (caller
        holds self._lock; stage values in SECONDS). Stamps seq/ts AND the
        record's rendered `stages` map (milliseconds) — derived here so a
        subclass cannot desync the in-ring percentile source (read as ms by
        stage_table's exact path) from the histogram source (seconds)."""
        self._seq += 1
        rec["seq"] = self._seq
        rec["ts"] = time.time()
        rec["stages"] = {k: round(v * 1000, 3) for k, v in stages.items()}
        self._records.append(rec)
        for k, v in stages.items():
            self._stage_totals[k] = self._stage_totals.get(k, 0.0) + v
            self._stage_batches[k] = self._stage_batches.get(k, 0) + 1
            self._hist_observe(k, v)
        return rec

    # -- read side -------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._records)

    def last(self) -> Optional[Dict]:
        with self._lock:
            return self._records[-1] if self._records else None

    @property
    def self_seconds(self) -> float:
        with self._lock:
            return self._self_s

    def stage_table(self, order=(), overlapped=frozenset()) -> Dict[str, Dict]:
        """Aggregate per-stage view across every record since clear() plus
        the outside buckets: {stage: {total_ms, mean_ms, p50_ms, p99_ms,
        batches, overlapped}}.

        Percentile source: nearest-rank over the per-record ring
        while every observation is still in it (exact); once eviction or
        per-call outside observations outgrow the ring, the windowed stage
        histogram takes over (bucket-interpolated, error bounded by the
        STAGE_P_BUCKETS ratio)."""
        with self._lock:
            totals = dict(self._stage_totals)
            batches = dict(self._stage_batches)
            outside = dict(self._outside)
            hists = dict(self._stage_hist)
            ring_vals: Dict[str, List[float]] = {}
            for rec in self._records:
                for k, ms in rec["stages"].items():
                    ring_vals.setdefault(k, []).append(ms)

        def pcts(name):
            h = hists.get(name)
            n_obs = h._total if h is not None else 0
            vals = ring_vals.get(name)
            if vals and len(vals) == n_obs:
                vals = sorted(vals)
                return (round(nearest_rank(vals, 0.50), 3),
                        round(nearest_rank(vals, 0.99), 3))
            if h is None or n_obs == 0:
                return None, None
            return (round(h.quantile(0.50) * 1000, 3),
                    round(h.quantile(0.99) * 1000, 3))

        out: Dict[str, Dict] = {}
        for name in order:
            sec = totals.get(name, 0.0) + outside.get(name, 0.0)
            n = batches.get(name, 0)
            if sec == 0.0 and n == 0:
                continue
            p50, p99 = pcts(name)
            out[name] = {
                "total_ms": round(sec * 1000, 3),
                "mean_ms": round(sec * 1000 / n, 3) if n else None,
                "p50_ms": p50,
                "p99_ms": p99,
                "batches": n,
                "overlapped": name in overlapped,
            }
        # anything recorded under a name the caller's order doesn't know
        # keeps rendering (forward compatibility for new stages)
        for name in set(totals) | set(outside):
            if name not in out:
                sec = totals.get(name, 0.0) + outside.get(name, 0.0)
                p50, p99 = pcts(name)
                out[name] = {"total_ms": round(sec * 1000, 3),
                             "mean_ms": None,
                             "p50_ms": p50,
                             "p99_ms": p99,
                             "batches": batches.get(name, 0),
                             "overlapped": False}
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._stage_totals.clear()
            self._stage_batches.clear()
            self._outside.clear()
            self._stage_hist.clear()
            self._self_s = 0.0
            self._clear_extra()

    def _clear_extra(self) -> None:
        """Subclass hook: clear subclass state (caller holds self._lock)."""
